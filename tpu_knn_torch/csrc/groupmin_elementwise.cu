// The spaces with no affine form: fused elementwise distance with a
// 128-row group-min epilogue (pass 1 of the exact scan), a distance epilogue
// (the single-pass and range scans, and every space.block of these spaces)
// or a batched epilogue (each query against its own gathered rows: pass 2,
// the graph scorers and the construction heuristic's pairs).
//
// Replaces what XLA fuses in tpu_knn/methods/seq_search.py:233 pass1_jnp: a
// lax.scan of space.block, which is tpu_knn/ops/distance.py:205
// elementwise_blocked, red(fn(q[:, None, :], x[None, :, :]), -1), then a min
// over 128-row groups; inside one jit the [Q, chunk, D] block never exists.
// No Pallas kernel stands behind it. For q f32[Q, D], x f32[N, D] and
// pad f32[N] (0, or 1e30 on padding rows) it computes
//
//     d[i, r] = post( reduce_k f(q[i, k], x[r, k]) ) + pad[r]
//
// in one of four forms, the formulas of tpu_knn_torch/ops/distance.py:
//
//   L1    f = |a - b|, sum                                     l1, dummy
//   LINF  f = |a - b|, NaN-carrying max                        linf
//   LP    f = |a - b|^p, sum, post powf(., 1/p)                lp
//   JS    f = 0.5 (t(a) + t(b)), t(v) = v (log v - log m) where v > 0,
//         else 0, m = 0.5 (a + b), every log of max(., 1e-38); sum; post
//         none, or sqrt(max(., 0)) for the jsmetr names
//
// and writes either the group mins out[i, g] = min over the 128 rows r of
// group g of d[i, r], f32[Q, N/128], over the whole corpus in one launch, or
// d itself, f32[Q, N], for one corpus slice. The batched epilogue (at the
// end of this file) computes the same d for q f32[B, Cq, D] against rows
// f32[B, K, D] with pad f32[B, K]: out[b, i, j], f32[B, Cq, K], each batch
// item's queries against its own rows (tpu_knn vmaps space.block there). The mins and the maxes carry NaN
// (min_nan.cuh), as torch.amin / torch.amax / torch.clamp_min do; v > 0 is
// false for a NaN v, as in torch.where.
//
// How each form takes its pair (f32 throughout):
//
//   LP, p one of LP_POWERS (an instance each): a product chain with its last
//     product fused into the sum, t = |a - b|: p=3 fmaf(t * t, t, acc), p=4
//     fmaf(t2, t2, acc), ... (NMSLIB's generic Lp does the same).
//   LP, any other p: ex2(p lg2 t) on the special-function unit (MUFU), the
//     non-FTZ PTX forms: a subnormal t keeps its power; t = 0 gives lg2 =
//     -inf and ex2 = 0, +inf stays +inf, NaN stays NaN.
//   JS, in quarter log2 units: La/4 = lg2(2 max(a, 1e-38)) / 4 per staged
//     element, then a pair takes one MUFU lg2, L = lg2(max(a + b, 2e-38)) =
//     lg2(2 max(m, 1e-38)), and adds a (La/4 - L/4) + b (Lb/4 - L/4), each
//     bracket one FFMA (L times -1/4 plus La/4: the same instruction count as
//     La - L); the post multiplies by 4 * 0.5 ln 2 = 2 ln 2. La and L are the
//     same function of the same value when a == b, so a row against itself
//     sums exact zeros, as the plain version does. A stage whose tiles hold
//     a negative or NaN value takes the pair with the plain version's
//     selects (v > 0 ? v (Lv/4 - L/4) : 0): there 0 * (Lv/4 - L/4) would
//     turn a NaN or infinite L into NaN where the plain term is 0. The
//     stage's flag is one block-wide OR at the barrier that ends its staging.
//     The quarter is exact (a power of two) and keeps the sum at 1 / (2 ln
//     2) = 0.72 times the plain version's: no distance overflows here that
//     the plain version keeps finite (in whole log2 units the sum was 2.885
//     times the plain one and overflowed past ~1.2e38). The clamp stays on
//     a + b, unscaled, at the normal 2e-38; an a + b that overflows gives
//     L = +inf and a -inf term, as the plain version's m does.
//
// What bounds it on an H100: instruction issue, 132 SMs x 4 schedulers a
// clock (128 FP32 lanes), and the MUFU's 16 results a clock an SM, an eighth
// of that. L1 and LINF take two FP32 instructions an element pair (a
// subtraction whose abs is a free operand modifier, then the add or the
// max), LP p=3 and p=4 three, JS ~6 and one MUFU (MUFU-bound: one MUFU
// costs the time of 8 FP32 instructions), LP at other p ~9 and two MUFU.
// Every corpus element read from device memory feeds BQ >= 64 pairs, far
// above the card's balance point, so bytes never bound it.
//
// Design (csrc/groupmin.cu's skeleton): each block owns BQ queries x 128
// rows (one group) and walks D in steps of 8 through double-buffered shared
// memory, the next step's tiles loaded while this one computes. Each thread
// keeps a TQ x TR register tile of accumulators: 8 x 8 (BQ = 128), two k
// steps a pass of the inner loop for the forms of two to five instructions
// a pair, one for LP's MUFU route; 8 x 4 (BQ = 64) for JS, whose a, La, b
// and Lb at 8 x 8 took the 128 registers of two blocks an SM and spilled.
// JS's row logs, La and Lb, are taken once, when a tile is staged into
// shared memory, not once a pair. Blocks are ordered
// query-tile fastest, so the query tiles that read one corpus group run
// together and the group comes from HBM once. The group-min epilogue takes
// each thread's min over its TR rows, then a shuffle min across the TX
// threads that share its queries.
//
// Built without fast math: 1e-38 is subnormal in f32, and flush-to-zero
// would turn the clamp into 0 and its log into -inf; LP's t may be
// subnormal. JS's lg2 takes the FTZ form: its inputs are clamped at 2e-38,
// which is normal, so it never sees a subnormal.
//
// Contract (checked by the Python wrapper, tpu_knn_torch/ops/elementwise.py):
// contiguous f32 tensors on one device, 16-byte aligned, D % 8 == 0 (zero
// columns change no distance of the four forms), p > 0 for LP (and p equal
// to the instance's power for a product chain), N % 128 == 0 for the
// group-min epilogue. Q and, for the distance epilogue, N may be ragged:
// rows past them load zeros and are not written. Offsets are 64-bit: Q * N
// passes 2^31. The batched epilogue takes the same, for any B, Cq and K.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "min_nan.cuh"
#include "pair_tiling.h"

namespace {

enum : int { L1 = 0, LINF = 1, LP = 2, JS = 3 };

constexpr int BN = 128;  // corpus rows per block: one group
constexpr int BK = 8;    // depth of one shared-memory stage
constexpr int NT = 256;  // threads per block
constexpr float JS_TINY = 1e-38f;
constexpr float JS_TINY2 = 2.f * JS_TINY;  // 2e-38, normal in f32
constexpr float JS_POST = 1.38629436f;     // 4 * 0.5 ln 2: the sums are in quarter log2 units
constexpr float HALF_MAX = 0x1.fffffep126f;  // FLT_MAX / 2: 2v overflows past it

// LP's integer powers with an instance of their own (a product chain); every
// other p takes the MUFU route, power 0. ops/elementwise.py LP_POWERS.
#define TK_LP_POWERS(X) X(3) X(4) X(5) X(6) X(7) X(8)

// F: the form; P: LP's integer power, or 0 (LP at any other p, and the
// other forms)
template <int F, int P>
struct Geo {
  static constexpr bool MUFU = F == JS || (F == LP && P == 0);
  static constexpr int TQ = 8;                // queries a thread
  static constexpr int TR = F == JS ? 4 : 8;  // rows a thread
  static constexpr int KU = MUFU ? 1 : 2;     // k steps in one pass of the inner loop
  static constexpr int TX = BN / TR;          // threads along the rows: 16 or 32
  static constexpr int TY = NT / TX;          // threads along the queries: 16 or 8
  static constexpr int BQ = TY * TQ;          // queries a block: 128 or 64
  static constexpr bool LOGS = F == JS;
};

// MUFU lg2 and ex2. The non-FTZ forms keep subnormal inputs and results
// (ptxas scales them around the MUFU operation); the FTZ lg2 is the bare
// MUFU operation, for inputs that are never subnormal.
__device__ __forceinline__ float lg2_approx(float v) {
  float r;
  asm("lg2.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float lg2_approx_ftz(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// JS's pair log, L = lg2(max(s, 2e-38)) for s = a + b: lg2 of twice m =
// 0.5 (a + b) clamped at 1e-38, NaN kept (a NaN s is a NaN L)
__device__ __forceinline__ float js_lg2(float s) { return lg2_approx_ftz(max_nan(s, JS_TINY2)); }

// JS's staged log of one element, La/4 = lg2(2 max(a, 1e-38)) / 4: js_lg2 of
// a + a, so that La/4 - L/4 is 0 exactly for a pair of equal elements (the
// quarter is exact); past FLT_MAX / 2, where 2a overflows, lg2(a) + 1
__device__ __forceinline__ float js_row_lg2(float v) {
  return 0.25f * (v > HALF_MAX ? lg2_approx_ftz(v) + 1.f : js_lg2(2.f * v));
}

// JS's bracket of one side of a pair, La/4 - L/4, as one FFMA
__device__ __forceinline__ float js_diff(float la4, float l) { return fmaf(l, -0.25f, la4); }

// t^N for N >= 1 by squaring
template <int N>
__device__ __forceinline__ float ipow(float t) {
  if constexpr (N == 1) {
    return t;
  } else if constexpr (N % 2 == 0) {
    const float h = ipow<N / 2>(t);
    return h * h;
  } else {
    return ipow<N - 1>(t) * t;
  }
}

// SIGNED: JS on a stage whose tiles hold a negative or NaN value; la and lb:
// JS's staged js_row_lg2 of a and b
template <int F, int P, bool SIGNED>
__device__ __forceinline__ void accumulate(float& acc, float a, float la, float b, float lb, float p) {
  if constexpr (F == L1) {
    acc = acc + fabsf(a - b);
  } else if constexpr (F == LINF) {
    acc = max_nan(acc, fabsf(a - b));
  } else if constexpr (F == LP && P > 0) {
    // t^P, its last product fused into the sum
    const float t = fabsf(a - b);
    if constexpr (P % 2 == 0) {
      const float h = ipow<P / 2>(t);
      acc = fmaf(h, h, acc);
    } else {
      acc = fmaf(ipow<P - 1>(t), t, acc);
    }
  } else if constexpr (F == LP) {
    acc = acc + ex2_approx(p * lg2_approx(fabsf(a - b)));
  } else if constexpr (!SIGNED) {
    // a, b >= 0 and no NaN: a (La/4 - L/4) is the plain version's term over
    // 2 ln 2, 0 at a = 0
    const float l = js_lg2(a + b);
    acc = fmaf(a, js_diff(la, l), acc);
    acc = fmaf(b, js_diff(lb, l), acc);
  } else {
    const float l = js_lg2(a + b);
    const float ta = a > 0.f ? a * js_diff(la, l) : 0.f;
    const float tb = b > 0.f ? b * js_diff(lb, l) : 0.f;
    acc = acc + (ta + tb);
  }
}

template <int F>
__device__ __forceinline__ float post(float s, float inv_p, int sqrt_post) {
  if constexpr (F == LP) {
    return powf(s, inv_p);
  } else if constexpr (F == JS) {
    const float d = JS_POST * s;
    return sqrt_post ? sqrtf(max_nan(d, 0.f)) : d;
  } else {
    return s;
  }
}

// JS's products of one stage into acc: at each of the stage's BK k steps,
// the thread's TQ queries (a, La) against its TR rows (b, Lb); SIGNED: the
// guarded pairs. The other forms keep this loop inline in the kernel: as a
// function or a lambda, even always inlined, it made ptxas spill 16 bytes in
// L1's and LINF's group-min instances.
template <bool SIGNED, int BQ>
__device__ __forceinline__ void js_stage(float (&acc)[Geo<JS, 0>::TQ][Geo<JS, 0>::TR], float (*qs)[BQ],
                                         float (*xs)[BN], float (*ql)[BQ], float (*xl)[BN], int tx, int ty) {
  constexpr int TQ = Geo<JS, 0>::TQ, TR = Geo<JS, 0>::TR;
  static_assert(Geo<JS, 0>::KU == 1, "js_stage takes one k step a pass");
#pragma unroll 1
  for (int kk = 0; kk < BK; ++kk) {
    float a[TQ], la[TQ], b[TR], lb[TR];
#pragma unroll
    for (int c = 0; c < TQ / 4; ++c) {
      const int o = c * (BQ / (TQ / 4)) + ty * 4;
      const float4 t = *reinterpret_cast<const float4*>(&qs[kk][o]);
      const float4 u = *reinterpret_cast<const float4*>(&ql[kk][o]);
      a[4 * c] = t.x, a[4 * c + 1] = t.y, a[4 * c + 2] = t.z, a[4 * c + 3] = t.w;
      la[4 * c] = u.x, la[4 * c + 1] = u.y, la[4 * c + 2] = u.z, la[4 * c + 3] = u.w;
    }
#pragma unroll
    for (int c = 0; c < TR / 4; ++c) {
      const int o = c * (BN / (TR / 4)) + tx * 4;
      const float4 t = *reinterpret_cast<const float4*>(&xs[kk][o]);
      const float4 u = *reinterpret_cast<const float4*>(&xl[kk][o]);
      b[4 * c] = t.x, b[4 * c + 1] = t.y, b[4 * c + 2] = t.z, b[4 * c + 3] = t.w;
      lb[4 * c] = u.x, lb[4 * c + 1] = u.y, lb[4 * c + 2] = u.z, lb[4 * c + 3] = u.w;
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) accumulate<JS, 0, SIGNED>(acc[i][j], a[i], la[i], b[j], lb[j], 0.f);
  }
}

template <int F, int P, bool GROUPMIN>
__global__ void __launch_bounds__(NT, 2)
groupmin_elementwise_kernel(const float* __restrict__ q, const float* __restrict__ x,
                            const float* __restrict__ pad, float* __restrict__ out, int64_t nq,
                            int64_t n, int d, float p, float inv_p, int sqrt_post, int64_t q_tiles) {
  using G = Geo<F, P>;
  constexpr int BQ = G::BQ, TQ = G::TQ, TR = G::TR, TX = G::TX;
  constexpr int LQ = G::LOGS ? BQ : 4, LN = G::LOGS ? BN : 4;
  // [stage][k][query or row]: a thread's 4 neighbouring queries (rows) at
  // one k are one 16-byte shared load
  __shared__ __align__(16) float qs[2][BK][BQ];
  __shared__ __align__(16) float xs[2][BK][BN];
  __shared__ __align__(16) float ql[2][BK][LQ];  // JS: js_row_lg2(q)
  __shared__ __align__(16) float xl[2][BK][LN];  // JS: js_row_lg2(x)

  const int64_t bid = blockIdx.x;
  const int64_t q0 = (bid % q_tiles) * BQ;
  const int64_t g = bid / q_tiles;
  const int64_t r0 = g * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;  // row slot
  const int ty = tid / TX;  // query slot

  // loader: the stage's BQ + BN rows of BK floats, one float4 a slot,
  // query rows first
  constexpr int SLOTS = (BQ + BN) * (BK / 4);
  constexpr int LOADS = (SLOTS + NT - 1) / NT;
  const float* src[LOADS];
  float* dst[LOADS];   // the slot's first element in stage 0 of qs or xs
  float* ldst[LOADS];  // JS: the same in ql or xl
  int stride[LOADS];   // BQ for a query row, BN for a corpus row
  bool has[LOADS];     // the slot exists
  bool live[LOADS];    // and its row is inside q or x
  float4 v[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int s = tid + l * NT;
    const int row = s / (BK / 4);
    const int col = (s % (BK / 4)) * 4;
    const bool is_q = row < BQ;
    const int64_t grow = is_q ? q0 + row : r0 + row - BQ;
    has[l] = s < SLOTS;
    live[l] = has[l] && grow < (is_q ? nq : n);
    src[l] = (is_q ? q : x) + (live[l] ? grow : 0) * (int64_t)d + col;
    dst[l] = is_q ? &qs[0][col][row] : &xs[0][col][row - BQ];
    if constexpr (G::LOGS) ldst[l] = is_q ? &ql[0][col][row] : &xl[0][col][row - BQ];
    stride[l] = is_q ? BQ : BN;
  }

  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l)
      v[l] = live[l] ? __ldg(reinterpret_cast<const float4*>(src[l] + k0)) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  int signed_vals = 0;  // JS: this thread staged a negative or NaN value
  // stores the fetched tiles in stage buf; JS: their logs too, and the flag
  auto stage = [&](int buf) {
    if constexpr (G::LOGS) signed_vals = 0;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      if (!has[l]) continue;
      const int off = buf * BK * stride[l];
      const float e[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[l][off + c * stride[l]] = e[c];
      if constexpr (G::LOGS) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ldst[l][off + c * stride[l]] = js_row_lg2(e[c]);
          signed_vals |= !(e[c] >= 0.f);
        }
      }
    }
  };

  float acc[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  // JS: the stage's tiles hold a negative or NaN value, the block-wide OR
  // taken at the barrier that ends its staging
  int signed_tile = 0;
  fetch(0);
  stage(0);
  if constexpr (G::LOGS) {
    signed_tile = __syncthreads_or(signed_vals);
  } else {
    __syncthreads();
  }

  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += BK) {
    const bool more = k0 + BK < d;
    if (more) fetch(k0 + BK);  // the next stage's loads fly while this one computes
    if constexpr (G::LOGS) {
      if (signed_tile) {
        js_stage<true>(acc, qs[buf], xs[buf], ql[buf], xl[buf], tx, ty);
      } else {
        js_stage<false>(acc, qs[buf], xs[buf], ql[buf], xl[buf], tx, ty);
      }
    } else {
#pragma unroll 1
      for (int kb = 0; kb < BK; kb += G::KU) {
#pragma unroll
        for (int ku = 0; ku < G::KU; ++ku) {
          const int kk = kb + ku;
          float a[TQ], la[TQ] = {}, b[TR], lb[TR] = {};  // la, lb: JS's (js_stage)
#pragma unroll
          for (int c = 0; c < TQ / 4; ++c) {
            const int o = c * (BQ / (TQ / 4)) + ty * 4;
            const float4 t = *reinterpret_cast<const float4*>(&qs[buf][kk][o]);
            a[4 * c] = t.x, a[4 * c + 1] = t.y, a[4 * c + 2] = t.z, a[4 * c + 3] = t.w;
          }
#pragma unroll
          for (int c = 0; c < TR / 4; ++c) {
            const int o = c * (BN / (TR / 4)) + tx * 4;
            const float4 t = *reinterpret_cast<const float4*>(&xs[buf][kk][o]);
            b[4 * c] = t.x, b[4 * c + 1] = t.y, b[4 * c + 2] = t.z, b[4 * c + 3] = t.w;
          }
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TR; ++j) accumulate<F, P, false>(acc[i][j], a[i], la[i], b[j], lb[j], p);
        }
      }
    }
    if (more) {
      // the other stage was last read before the previous barrier
      stage(buf ^ 1);
      if constexpr (G::LOGS) {
        signed_tile = __syncthreads_or(signed_vals);
      } else {
        __syncthreads();
      }
      buf ^= 1;
    }
  }

  // the thread's rows and queries, as the loads above laid them out
  auto row_of = [&](int j) { return (j / 4) * (BN / (TR / 4)) + tx * 4 + j % 4; };
  auto query_of = [&](int i) { return q0 + (i / 4) * (BQ / (TQ / 4)) + ty * 4 + i % 4; };
  float pr[TR];
#pragma unroll
  for (int j = 0; j < TR; ++j) {
    const int64_t r = r0 + row_of(j);
    pr[j] = r < n ? pad[r] : 0.f;
  }

  if constexpr (GROUPMIN) {
    const int64_t n_groups = n / BN;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      float m = __fadd_rn(post<F>(acc[i][0], inv_p, sqrt_post), pr[0]);
#pragma unroll
      for (int j = 1; j < TR; ++j) m = min_nan(m, __fadd_rn(post<F>(acc[i][j], inv_p, sqrt_post), pr[j]));
      // the TX threads sharing these queries are TX neighbouring lanes
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) m = min_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int64_t qi = query_of(i);
      if (tx == 0 && qi < nq) out[qi * n_groups + g] = m;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int64_t qi = query_of(i);
      if (qi >= nq) continue;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int64_t r = r0 + row_of(j);
        if (r < n) out[qi * n + r] = __fadd_rn(post<F>(acc[i][j], inv_p, sqrt_post), pr[j]);
      }
    }
  }
}

template <int F, int P, bool GROUPMIN>
int launch(const void* q, const void* x, const void* pad, void* out, int64_t nq, int64_t n, int d,
           float p, float inv_p, int sqrt_post, cudaStream_t stream) {
  const int64_t q_tiles = (nq + Geo<F, P>::BQ - 1) / Geo<F, P>::BQ;
  const int64_t blocks = q_tiles * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  groupmin_elementwise_kernel<F, P, GROUPMIN><<<(unsigned)blocks, NT, 0, stream>>>(
      (const float*)q, (const float*)x, (const float*)pad, (float*)out, nq, n, d, p, inv_p, sqrt_post,
      q_tiles);
  return (int)cudaGetLastError();
}

template <int F, int P>
int launch_form(int groupmin, const void* q, const void* x, const void* pad, void* out, int64_t nq,
                int64_t n, int d, float p, float inv_p, int sqrt_post, cudaStream_t stream) {
  return groupmin ? launch<F, P, true>(q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, stream)
                  : launch<F, P, false>(q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, stream);
}

template <int F, int P>
int put_geometry(int* out) {
  using G = Geo<F, P>;
  out[0] = G::TQ, out[1] = G::TR, out[2] = G::KU, out[3] = G::BQ;
  return 0;
}


// ---- the batched epilogue ----
//
// out[b, i, j] = post(reduce_k f(q[b, i, k], rows[b, j, k])) + pad[b, j] for
// q f32[B, Cq, D], rows f32[B, K, D], pad f32[B, K]: what tpu_knn computes by
// vmapping space.block over the batch (ops/graph.py score_gathered, pass 2
// and the beam, Cq = 1; methods/hnsw.py _score_pairs, the heuristic's and
// sw-graph's pairs, Cq = C). No Pallas kernel stands behind it either. Two
// kernels, by Cq.
//
// Cq = 1, the gathered form: the bytes bound it, each gathered row read once
// and used by one query (pass 2 at Q = 2048 reads 1.6 GB of rows for 0.4 G
// element pairs). A warp a row, its 32 lanes over 128 columns of D (one
// 16-byte load each), so a row is read in full 512-byte lines. A block owns
// one batch item and BR = 32 rows (4 a warp) and walks D in steps of 128 with
// the step's query columns (and, for JS, their staged logs) in shared memory,
// its loads in flight with the rows' loads. Each lane keeps one sum a row and
// a warp's shuffle reduction ends it; the sums go through shared memory so
// that the BR distances are stored side by side. JS always takes the guarded
// pair (a negative or NaN value anywhere is handled), its row logs taken once
// a row and step, its query logs once a staged step.
//
// Cq > 1, the pair form (the construction heuristic's C x C pairs, sw-graph's
// patches): an item's element pairs are Cq x K x D against (Cq + K) x D
// values read, so the form's work bounds it where C is large (the forward
// heuristic's Cq = K = 108 at B = 1024), and the bytes where C is small and B
// large (the reverse shrink's 24 and 40 at B = 16384 read 0.44 and 0.78 GB,
// and their arithmetic a pair is about as long as its share of the bytes).
// The design is the group-min kernel's, cut into per-item tiles: each thread
// keeps a 4 x 4 register tile of (query, row) sums of one batch item over all
// of D, summing k in sequence (no sum crosses lanes), and reads its operands
// from double-buffered shared-memory stages of 16 columns, each 16-byte load
// feeding 4 pairs. An item's pairs are cut into qt x rt block tiles of ny x
// nx threads (qt ny 4 >= Cq, rt nx 4 >= K); a block holds g items' tiles side
// by side, so that 24 or 40 fill a block (one tile an item: no vector read
// twice), and 108 is 1 x 3 blocks of 27 x 9 threads, every pair real.
// pair_tiling (pair_tiling.h) picks the split and g from Cq and K, costing
// each candidate by the pair slots its threads take against the bytes its
// item reads, so that 89-98% of the pairs computed at 24, 40 and 108 are real
// and every thread issues at most 4 loads a stage; threads past the item
// tiles only load. (An 8 x 8 tile, as the group-min kernel's, lost on the card at every
// shape and form but L1 at 108 x 108, where it won by little: its coarser
// tiles waste more pairs.) The next stage's 16-byte loads fly
// while this one computes, and 16 columns a stage keep more bytes in flight
// for the byte-bound shapes; stage layout [vector group][k][4 vectors], a
// group's k steps padded to 17 so that neighbouring threads' groups fall on
// different banks. JS's logs are taken as a stage is stored, and a stage
// holding a negative or NaN value takes the guarded pair, one block-wide OR
// at its barrier, as in the group-min kernel. The per-pair arithmetic is
// accumulate<F, P, SIGNED> and post<F>, so only the order of the f32 sums
// differs from the other
// epilogues; LINF's max is the same in any order.

// The gathered kernel's tiling at QG = 1 query staged a pass: RW rows a
// warp, BR rows a block. QG stays a template argument with its one value,
// and the kernel the text its times were measured with: written out with
// QG = 1, nvcc emitted fewer instructions for L1 (a different kernel, to be
// measured on its own)
template <int QG>
struct BatchedGeo {
  static_assert(QG == 1, "the pair form has its own kernel");
  static constexpr int RW = 4;
  static constexpr int BR = (NT / 32) * RW;
  static constexpr int MIN_BLOCKS = 2;
};
constexpr int BD = 128;  // D columns a step: 32 lanes x 4

template <int F>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (F == LINF) {
    return max_nan(a, b);
  } else {
    return a + b;
  }
}

// The reduction over the warp's 32 lanes of v[0]: every lane gets it
template <int F, int N>
__device__ __forceinline__ float warp_reduce(float (&v)[N], int lane) {
  static_assert(N == 1, "one sum");
  float r = v[0];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) r = combine<F>(r, __shfl_xor_sync(0xffffffffu, r, off));
  return r;
}

__device__ __forceinline__ float4 js_row_lg2_4(float4 v) {
  return make_float4(js_row_lg2(v.x), js_row_lg2(v.y), js_row_lg2(v.z), js_row_lg2(v.w));
}

template <int F, int P>
__device__ __forceinline__ void accumulate4(float& acc, float4 a, float4 la, float4 b, float4 lb, float p) {
  // JS always takes the guarded pair (F == JS: SIGNED)
  accumulate<F, P, true>(acc, a.x, la.x, b.x, lb.x, p);
  accumulate<F, P, true>(acc, a.y, la.y, b.y, lb.y, p);
  accumulate<F, P, true>(acc, a.z, la.z, b.z, lb.z, p);
  accumulate<F, P, true>(acc, a.w, la.w, b.w, lb.w, p);
}

template <int F, int P, int QG>
__global__ void __launch_bounds__(NT, BatchedGeo<QG>::MIN_BLOCKS)
elementwise_batched_kernel(const float* __restrict__ q, const float* __restrict__ rows,
                           const float* __restrict__ pad, float* __restrict__ out, int cq, int64_t k, int d,
                           float p, float inv_p, int sqrt_post, int64_t row_tiles) {
  constexpr int RW = BatchedGeo<QG>::RW, BR = BatchedGeo<QG>::BR;
  constexpr int STAGE = (QG * 32 + NT - 1) / NT;  // staged float4 slots a thread
  constexpr bool LOGS = F == JS;
  __shared__ __align__(16) float4 qs[QG][32];             // a step's columns of QG queries
  __shared__ __align__(16) float4 ql[LOGS ? QG : 1][32];  // JS: their js_row_lg2
  __shared__ float res[QG][BR + 1];                       // the sums, query-major

  const int64_t b = blockIdx.x / row_tiles;
  const int64_t j0 = (blockIdx.x % row_tiles) * BR;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* qb = q + b * cq * (int64_t)d;
  const float* xb = rows + b * k * (int64_t)d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int q0 = 0; q0 < cq; q0 += QG) {
    float acc[RW][QG];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int i = 0; i < QG; ++i) acc[r][i] = 0.f;

    for (int d0 = 0; d0 < d; d0 += BD) {
      // the step's query columns and this warp's row columns, all loads in
      // flight at once; columns past D and rows past K load zeros: f(0, 0)
      // adds nothing
      float4 sv[STAGE];
#pragma unroll
      for (int l = 0; l < STAGE; ++l) {
        const int s = tid + l * NT, i = s / 32, col = d0 + 4 * (s % 32);
        sv[l] = s < QG * 32 && q0 + i < cq && col < d
                    ? __ldg(reinterpret_cast<const float4*>(qb + (int64_t)(q0 + i) * d + col))
                    : zero;
      }
      const int col = d0 + 4 * lane;
      float4 xv[RW], xl[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int64_t j = j0 + warp * RW + r;
        xv[r] = j < k && col < d ? __ldg(reinterpret_cast<const float4*>(xb + j * d + col)) : zero;
      }
      __syncthreads();  // the previous step's tiles and sums are read
#pragma unroll
      for (int l = 0; l < STAGE; ++l) {
        const int s = tid + l * NT;
        if (s < QG * 32) {
          qs[s / 32][s % 32] = sv[l];
          if constexpr (LOGS) ql[s / 32][s % 32] = js_row_lg2_4(sv[l]);
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        xl[r] = zero;
        if constexpr (LOGS) xl[r] = js_row_lg2_4(xv[r]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < QG; ++i) {
        const float4 a = qs[i][lane];
        float4 la = zero;
        if constexpr (LOGS) la = ql[i][lane];
#pragma unroll
        for (int r = 0; r < RW; ++r) accumulate4<F, P>(acc[r][i], a, la, xv[r], xl[r], p);
      }
    }

#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float tot = warp_reduce<F, QG>(acc[r], lane);
      if (QG > 1 || lane == 0) res[QG > 1 ? lane : 0][warp * RW + r] = tot;
    }
    __syncthreads();
    for (int s = tid; s < QG * BR; s += NT) {
      const int i = s / BR, jj = s % BR;
      const int64_t j = j0 + jj;
      if (q0 + i < cq && j < k)
        out[(b * cq + q0 + i) * k + j] = __fadd_rn(post<F>(res[i][jj], inv_p, sqrt_post), pad[b * k + j]);
    }
  }
}

// One stage's pairs into acc: at each of its BK k steps (unrolled: the loads'
// offsets are immediates) the thread's TQ queries (a, and JS's La) against
// its TR rows (b, Lb). qv, xv: the thread's vector groups in the stage's
// values; ql, xl: the same in JS's logs.
template <int F, int P, bool SIGNED>
__device__ __forceinline__ void pair_stage(float (&acc)[PAIR_TQ][PAIR_TR], const float4* qv, const float4* xv,
                                           const float4* ql, const float4* xl, float p) {
  constexpr bool LOGS = F == JS;
#pragma unroll
  for (int kk = 0; kk < PAIR_BK; ++kk) {
    const float4 t = qv[kk], u = xv[kk];
    const float a[PAIR_TQ] = {t.x, t.y, t.z, t.w}, b[PAIR_TR] = {u.x, u.y, u.z, u.w};
    float la[PAIR_TQ] = {}, lb[PAIR_TR] = {};
    if constexpr (LOGS) {
      const float4 v = ql[kk], w = xl[kk];
      la[0] = v.x, la[1] = v.y, la[2] = v.z, la[3] = v.w;
      lb[0] = w.x, lb[1] = w.y, lb[2] = w.z, lb[3] = w.w;
    }
#pragma unroll
    for (int i = 0; i < PAIR_TQ; ++i)
#pragma unroll
      for (int j = 0; j < PAIR_TR; ++j) accumulate<F, P, SIGNED>(acc[i][j], a[i], la[i], b[j], lb[j], p);
  }
}

// blocks an SM: held to 85 registers so that three fit (left free, ptxas
// took more, two blocks fit, and the byte-bound shapes ran slower)
template <int F, int P>
__global__ void __launch_bounds__(PAIR_THREADS, 3)
elementwise_pair_kernel(const float* __restrict__ q, const float* __restrict__ rows,
                        const float* __restrict__ pad, float* __restrict__ out, int64_t nb, int cq, int64_t k,
                        int d, float p, float inv_p, int sqrt_post, PairTiling t) {
  constexpr int TQ = PAIR_TQ, TR = PAIR_TR, BK = PAIR_BK, LOADS = PAIR_LOADS;
  constexpr int CH = BK / 4;  // 16-byte chunks of a vector in one stage
  constexpr int KS = BK + 1;  // float4s a vector group takes in a stage
  constexpr bool LOGS = F == JS;
  // [stage][vector group][KS] float4s: element (vector v, column c) of a
  // stage is component v % 4 of float4 c of group v / 4; queries' groups
  // first, item by item, then the rows'
  extern __shared__ float4 pair_smem[];
  const int ctq = t.ny * TQ, ctr = t.nx * TR;  // an item's query and row slots a block
  const int qvecs = t.g * ctq, groups = (qvecs + t.g * ctr) / 4;
  float4* const vals = pair_smem;
  float4* const logs = pair_smem + 2 * groups * KS;  // JS: js_row_lg2 of vals

  const int64_t tiles = (int64_t)t.qt * t.rt;
  const int64_t b0 = blockIdx.x / tiles * t.g;
  const int tile = (int)(blockIdx.x % tiles);
  const int64_t q0 = (int64_t)(tile / t.rt) * ctq;
  const int64_t r0 = (int64_t)(tile % t.rt) * ctr;
  const int tid = threadIdx.x;

  // loader: slot s of a stage is chunk s % CH of vector s / CH, spread over
  // every thread of the block
  const float* src[LOADS];  // the slot's vector at its chunk, or nullptr past the batch, Cq or K
  int dst[LOADS];           // the float offset of its first element in stage 0, or -1: no slot
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int s = tid + l * (int)blockDim.x;
    const int v = s / CH, c = s % CH;
    const bool is_q = v < qvecs;
    const int vv = is_q ? v : v - qvecs;  // the vector within its side
    const int per = is_q ? ctq : ctr;
    const int64_t b = b0 + vv / per, idx = (is_q ? q0 : r0) + vv % per;
    const bool has = s < groups * 4 * CH;
    const bool live = has && b < nb && idx < (is_q ? (int64_t)cq : k);
    src[l] = live ? (is_q ? q + (b * cq + idx) * d : rows + (b * k + idx) * d) + 4 * c : nullptr;
    const int grp = (is_q ? 0 : qvecs / 4) + vv / 4;
    dst[l] = has ? (grp * KS + 4 * c) * 4 + vv % 4 : -1;
  }
  float4 v[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int col = k0 + 4 * ((tid + l * (int)blockDim.x) % CH);
      v[l] = src[l] != nullptr && col < d ? __ldg(reinterpret_cast<const float4*>(src[l] + k0))
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  int signed_vals = 0;  // JS: this thread staged a negative or NaN value
  auto stage = [&](int buf) {
    float* const sv = reinterpret_cast<float*>(vals + buf * groups * KS);
    float* const sl = reinterpret_cast<float*>(logs + buf * groups * KS);
    if constexpr (LOGS) signed_vals = 0;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      if (dst[l] < 0) continue;
      const float e[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) sv[dst[l] + 4 * c] = e[c];  // column + c: the next float4 of the group
      if constexpr (LOGS) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sl[dst[l] + 4 * c] = js_row_lg2(e[c]);
          signed_vals |= !(e[c] >= 0.f);
        }
      }
    }
  };

  // the thread's item tile: item gi of the block, query slot ty, row slot
  // tx; its queries are the 4 vectors of group ty of its item, its rows those
  // of group tx (neighbouring threads on neighbouring groups)
  const int per_item = t.ny * t.nx;
  const bool computes = tid < t.g * per_item;
  const int gi = tid / per_item, ty = tid % per_item / t.nx, tx = tid % per_item % t.nx;
  const int qg = gi * t.ny + ty, xg = qvecs / 4 + gi * t.nx + tx;

  float acc[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  // JS: the stage's tiles hold a negative or NaN value, the block-wide OR
  // taken at the barrier that ends its staging
  int signed_tile = 0;
  fetch(0);
  stage(0);
  if constexpr (LOGS) {
    signed_tile = __syncthreads_or(signed_vals);
  } else {
    __syncthreads();
  }

  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += BK) {
    const bool more = k0 + BK < d;
    if (more) fetch(k0 + BK);  // the next stage's loads fly while this one computes
    if (computes) {
      const float4* const base = vals + buf * groups * KS;
      const float4* const lbase = logs + buf * groups * KS;
      const float4 *qv = base + qg * KS, *xv = base + xg * KS, *ql = lbase + qg * KS, *xl = lbase + xg * KS;
      if constexpr (LOGS) {
        if (signed_tile) {
          pair_stage<F, P, true>(acc, qv, xv, ql, xl, p);
        } else {
          pair_stage<F, P, false>(acc, qv, xv, ql, xl, p);
        }
      } else {
        pair_stage<F, P, false>(acc, qv, xv, ql, xl, p);
      }
    }
    if (more) {
      // the other stage was last read before the previous barrier
      stage(buf ^ 1);
      if constexpr (LOGS) {
        signed_tile = __syncthreads_or(signed_vals);
      } else {
        __syncthreads();
      }
      buf ^= 1;
    }
  }

  if (!computes) return;
  const int64_t b = b0 + gi;
  if (b >= nb) return;
  // the thread's query i and row j, as the groups above lay them out
  const int64_t qb = q0 + ty * 4, rb = r0 + tx * 4;
  float pr[TR];
#pragma unroll
  for (int j = 0; j < TR; ++j) pr[j] = rb + j < k ? pad[b * k + rb + j] : 0.f;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (qb + i >= cq) continue;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      if (rb + j < k) out[(b * cq + qb + i) * k + rb + j] = __fadd_rn(post<F>(acc[i][j], inv_p, sqrt_post), pr[j]);
    }
  }
}

template <int F, int P, int QG>
int launch_batched(const void* q, const void* rows, const void* pad, void* out, int64_t nb, int cq, int64_t k,
                   int d, float p, float inv_p, int sqrt_post, cudaStream_t stream) {
  const int64_t row_tiles = (k + BatchedGeo<QG>::BR - 1) / BatchedGeo<QG>::BR;
  const int64_t blocks = nb * row_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  elementwise_batched_kernel<F, P, QG><<<(unsigned)blocks, NT, 0, stream>>>(
      (const float*)q, (const float*)rows, (const float*)pad, (float*)out, cq, k, d, p, inv_p, sqrt_post,
      row_tiles);
  return (int)cudaGetLastError();
}

template <int F, int P>
int launch_pair(const void* q, const void* rows, const void* pad, void* out, int64_t nb, int cq, int64_t k, int d,
                float p, float inv_p, int sqrt_post, cudaStream_t stream) {
  const PairTiling t = pair_tiling(cq, k, F == JS);
  const int64_t blocks = (nb + t.g - 1) / t.g * t.qt * t.rt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kern = elementwise_pair_kernel<F, P>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, t.threads, t.smem, stream>>>((const float*)q, (const float*)rows, (const float*)pad,
                                                         (float*)out, nb, cq, k, d, p, inv_p, sqrt_post, t);
  return (int)cudaGetLastError();
}

// Cq = 1 the gathered kernel, else the pair kernel
template <int F, int P>
int launch_batched_form(const void* q, const void* rows, const void* pad, void* out, int64_t nb, int cq,
                        int64_t k, int d, float p, float inv_p, int sqrt_post, cudaStream_t stream) {
  if (cq == 1) return launch_batched<F, P, 1>(q, rows, pad, out, nb, cq, k, d, p, inv_p, sqrt_post, stream);
  return launch_pair<F, P>(q, rows, pad, out, nb, cq, k, d, p, inv_p, sqrt_post, stream);
}

}  // namespace

extern "C" {

// form: 0 L1, 1 LINF, 2 LP, 3 JS; lp_power: LP's integer power with an
// instance of its own (TK_LP_POWERS; p must equal it), or 0 for LP at any p
// by ex2(p lg2 t) and for the other forms; groupmin: 1 for the group mins
// f32[Q, N/128], 0 for the distances f32[Q, N]; inv_p: 1/p as the caller
// rounds it (LP); sqrt_post: JS's metric post. Launches on `stream` and
// returns cudaGetLastError(): a launch the card refuses never runs, and only
// this code reports it.
int tk_elementwise(int form, int lp_power, int groupmin, const void* q, const void* x, const void* pad,
                   void* out, long long nq, long long n, int d, float p, float inv_p, int sqrt_post,
                   void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d % BK != 0 || (groupmin && n % BN != 0)) return (int)cudaErrorInvalidValue;
  if (lp_power != 0 && (form != LP || p != (float)lp_power)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case L1: return launch_form<L1, 0>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
    case LINF: return launch_form<LINF, 0>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
    case LP:
      if (!(p > 0.f)) return (int)cudaErrorInvalidValue;
      switch (lp_power) {
        case 0: return launch_form<LP, 0>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
#define TK_LP_CASE(P) \
  case P: return launch_form<LP, P>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
        TK_LP_POWERS(TK_LP_CASE)
#undef TK_LP_CASE
        default: return (int)cudaErrorInvalidValue;
      }
    case JS: return launch_form<JS, 0>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiling of an instance, for counting its instructions an element pair:
// out = {TQ, TR, KU (k steps in one pass of the inner loop), BQ}.
int tk_elementwise_geometry(int form, int lp_power, int* out) {
  if (lp_power != 0 && form != LP) return (int)cudaErrorInvalidValue;
  switch (form) {
    case L1: return put_geometry<L1, 0>(out);
    case LINF: return put_geometry<LINF, 0>(out);
    case LP:
      switch (lp_power) {
        case 0: return put_geometry<LP, 0>(out);
#define TK_LP_CASE(P) \
  case P: return put_geometry<LP, P>(out);
        TK_LP_POWERS(TK_LP_CASE)
#undef TK_LP_CASE
        default: return (int)cudaErrorInvalidValue;
      }
    case JS: return put_geometry<JS, 0>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The batched epilogue: out[b, i, j] f32[B, Cq, K] for q f32[B, Cq, D],
// rows f32[B, K, D] and pad f32[B, K]; form, lp_power, p, inv_p and
// sqrt_post as in tk_elementwise. Cq = 1 runs the gathered kernel, Cq > 1
// the pair kernel at pair_tiling(Cq, K). Launches on `stream` and returns
// cudaGetLastError().
int tk_elementwise_batched(int form, int lp_power, const void* q, const void* rows, const void* pad, void* out,
                           long long nb, int cq, long long k, int d, float p, float inv_p, int sqrt_post,
                           void* stream) {
  if (nb <= 0 || cq <= 0 || k <= 0) return (int)cudaSuccess;
  if (d <= 0 || d % BK != 0) return (int)cudaErrorInvalidValue;
  if (lp_power != 0 && (form != LP || p != (float)lp_power)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case L1: return launch_batched_form<L1, 0>(q, rows, pad, out, nb, cq, k, d, p, inv_p, sqrt_post, s);
    case LINF: return launch_batched_form<LINF, 0>(q, rows, pad, out, nb, cq, k, d, p, inv_p, sqrt_post, s);
    case LP:
      if (!(p > 0.f)) return (int)cudaErrorInvalidValue;
      switch (lp_power) {
        case 0: return launch_batched_form<LP, 0>(q, rows, pad, out, nb, cq, k, d, p, inv_p, sqrt_post, s);
#define TK_LP_CASE(P) \
  case P: return launch_batched_form<LP, P>(q, rows, pad, out, nb, cq, k, d, p, inv_p, sqrt_post, s);
        TK_LP_POWERS(TK_LP_CASE)
#undef TK_LP_CASE
        default: return (int)cudaErrorInvalidValue;
      }
    case JS: return launch_batched_form<JS, 0>(q, rows, pad, out, nb, cq, k, d, p, inv_p, sqrt_post, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The batched epilogue's tiling of form at cq queries against k rows an
// item: Cq = 1 the gathered kernel's out = {rows a warp, rows a block, D
// columns a step}; Cq > 1 the pair kernel's pair_tiling, out = {ny, nx, g,
// qt, rt, threads, shared bytes, TQ, TR, BK}.
int tk_elementwise_batched_geometry(int form, int cq, long long k, int* out) {
  if (cq <= 0 || k <= 0 || form < L1 || form > JS) return (int)cudaErrorInvalidValue;
  if (cq == 1) {
    out[0] = BatchedGeo<1>::RW, out[1] = BatchedGeo<1>::BR, out[2] = BD;
    return 0;
  }
  put_pair_tiling(pair_tiling(cq, k, form == JS), out);
  return 0;
}

const char* tk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
