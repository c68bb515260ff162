// The exact scan of the spaces with no affine form: fused elementwise
// distance with a 128-row group-min epilogue (pass 1) or a distance
// epilogue (the single-pass and range scans).
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
//   LP    f = |a - b|^p (powf), sum, post ^(1/p)               lp
//   JS    f = 0.5 (t(a) + t(b)), t(v) = v (log v - log m) where v > 0,
//         else 0, m = 0.5 (a + b), every log of max(., 1e-38); sum; post
//         none, or sqrt(max(., 0)) for the jsmetr names
//
// and writes either the group mins out[i, g] = min over the 128 rows r of
// group g of d[i, r], f32[Q, N/128], over the whole corpus in one launch, or
// d itself, f32[Q, N], for one corpus slice. The mins and the maxes carry NaN
// (min_nan.cuh), as torch.amin / torch.amax / torch.clamp_min do; v > 0 is
// false for a NaN v, as in torch.where.
//
// What bounds it on an H100: FP32 instruction issue, 132 SMs x 128 lanes a
// clock. L1 and LINF take two instructions an element pair (a subtraction
// whose abs is a free operand modifier, then the add or the max); JS one
// accurate logf of m and ~15 more; LP one powf. Every corpus element read
// from device memory feeds BQ >= 64 pairs, far above the card's balance
// point, so bytes never bound it.
//
// Design (csrc/groupmin.cu's skeleton): each block owns BQ queries x 128
// rows (one group) and walks D in steps of 8 through double-buffered shared
// memory, the next step's tiles loaded while this one computes. Each thread
// keeps a TQ x TR register tile of accumulators: 8 x 8 for L1 and LINF
// (BQ = 128), 8 x 4 for LP and JS (BQ = 64), whose inlined powf / logf take
// registers and code: 64 of them in a loop body would not fit the
// instruction cache. JS's row logs, log a and log b, are taken once, when a
// tile is staged into shared memory, not once a pair. Blocks are ordered
// query-tile fastest, so the query tiles that read one corpus group run
// together and the group comes from HBM once. The group-min epilogue takes
// each thread's min over its TR rows, then a shuffle min across the TX
// threads that share its queries.
//
// Built without fast math: 1e-38 is subnormal in f32, and flush-to-zero
// would turn the clamp into 0 and its log into -inf.
//
// Contract (checked by the Python wrapper, tpu_knn_torch/ops/elementwise.py):
// contiguous f32 tensors on one device, 16-byte aligned, D % 8 == 0 (zero
// columns change no distance of the four forms), p > 0 for LP, N % 128 == 0
// for the group-min epilogue. Q and, for the distance epilogue, N may be
// ragged: rows past them load zeros and are not written. Offsets are 64-bit:
// Q * N passes 2^31.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "min_nan.cuh"

namespace {

enum : int { L1 = 0, LINF = 1, LP = 2, JS = 3 };

constexpr int BN = 128;  // corpus rows per block: one group
constexpr int BK = 8;    // depth of one shared-memory stage
constexpr int NT = 256;  // threads per block
constexpr float JS_TINY = 1e-38f;

template <int F>
struct Geo {
  static constexpr bool WIDE = F == L1 || F == LINF;
  static constexpr int TQ = 8;             // queries a thread
  static constexpr int TR = WIDE ? 8 : 4;  // rows a thread
  static constexpr int KU = WIDE ? 2 : 1;  // k steps in one pass of the inner loop
  static constexpr int TX = BN / TR;       // threads along the rows: 16 or 32
  static constexpr int TY = NT / TX;       // threads along the queries: 16 or 8
  static constexpr int BQ = TY * TQ;       // queries a block: 128 or 64
  static constexpr bool LOGS = F == JS;
};

__device__ __forceinline__ float js_log(float v) { return logf(max_nan(v, JS_TINY)); }

template <int F>
__device__ __forceinline__ void accumulate(float& acc, float a, float la, float b, float lb, float p) {
  if constexpr (F == L1) {
    acc = acc + fabsf(a - b);
  } else if constexpr (F == LINF) {
    acc = max_nan(acc, fabsf(a - b));
  } else if constexpr (F == LP) {
    acc = acc + powf(fabsf(a - b), p);
  } else {
    const float lm = js_log((a + b) * 0.5f);
    const float ta = a > 0.f ? a * (la - lm) : 0.f;
    const float tb = b > 0.f ? b * (lb - lm) : 0.f;
    acc = acc + 0.5f * (ta + tb);
  }
}

template <int F>
__device__ __forceinline__ float post(float s, float inv_p, int sqrt_post) {
  if constexpr (F == LP) {
    return powf(s, inv_p);
  } else if constexpr (F == JS) {
    return sqrt_post ? sqrtf(max_nan(s, 0.f)) : s;
  } else {
    return s;
  }
}

template <int F, bool GROUPMIN>
__global__ void __launch_bounds__(NT, 2)
groupmin_elementwise_kernel(const float* __restrict__ q, const float* __restrict__ x,
                            const float* __restrict__ pad, float* __restrict__ out, int64_t nq,
                            int64_t n, int d, float p, float inv_p, int sqrt_post, int64_t q_tiles) {
  using G = Geo<F>;
  constexpr int BQ = G::BQ, TQ = G::TQ, TR = G::TR, TX = G::TX;
  constexpr int LQ = G::LOGS ? BQ : 4, LN = G::LOGS ? BN : 4;
  // [stage][k][query or row]: a thread's 4 neighbouring queries (rows) at
  // one k are one 16-byte shared load
  __shared__ __align__(16) float qs[2][BK][BQ];
  __shared__ __align__(16) float xs[2][BK][BN];
  __shared__ __align__(16) float ql[2][BK][LQ];  // JS: log max(q, 1e-38)
  __shared__ __align__(16) float xl[2][BK][LN];  // JS: log max(x, 1e-38)

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
  auto stage = [&](int buf) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      if (!has[l]) continue;
      const int off = buf * BK * stride[l];
      const float e[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[l][off + c * stride[l]] = e[c];
      if constexpr (G::LOGS) {
#pragma unroll
        for (int c = 0; c < 4; ++c) ldst[l][off + c * stride[l]] = js_log(e[c]);
      }
    }
  };

  float acc[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += BK) {
    const bool more = k0 + BK < d;
    if (more) fetch(k0 + BK);  // the next stage's loads fly while this one computes
#pragma unroll 1
    for (int kb = 0; kb < BK; kb += G::KU) {
#pragma unroll
      for (int ku = 0; ku < G::KU; ++ku) {
        const int kk = kb + ku;
        float a[TQ], la[TQ] = {}, b[TR], lb[TR] = {};  // la, lb: JS only
#pragma unroll
        for (int c = 0; c < TQ / 4; ++c) {
          const int o = c * (BQ / (TQ / 4)) + ty * 4;
          const float4 t = *reinterpret_cast<const float4*>(&qs[buf][kk][o]);
          a[4 * c] = t.x, a[4 * c + 1] = t.y, a[4 * c + 2] = t.z, a[4 * c + 3] = t.w;
          if constexpr (G::LOGS) {
            const float4 u = *reinterpret_cast<const float4*>(&ql[buf][kk][o]);
            la[4 * c] = u.x, la[4 * c + 1] = u.y, la[4 * c + 2] = u.z, la[4 * c + 3] = u.w;
          }
        }
#pragma unroll
        for (int c = 0; c < TR / 4; ++c) {
          const int o = c * (BN / (TR / 4)) + tx * 4;
          const float4 t = *reinterpret_cast<const float4*>(&xs[buf][kk][o]);
          b[4 * c] = t.x, b[4 * c + 1] = t.y, b[4 * c + 2] = t.z, b[4 * c + 3] = t.w;
          if constexpr (G::LOGS) {
            const float4 u = *reinterpret_cast<const float4*>(&xl[buf][kk][o]);
            lb[4 * c] = u.x, lb[4 * c + 1] = u.y, lb[4 * c + 2] = u.z, lb[4 * c + 3] = u.w;
          }
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TR; ++j) accumulate<F>(acc[i][j], a[i], la[i], b[j], lb[j], p);
      }
    }
    if (more) {
      // the other stage was last read before the previous barrier
      stage(buf ^ 1);
      __syncthreads();
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

template <int F, bool GROUPMIN>
int launch(const void* q, const void* x, const void* pad, void* out, int64_t nq, int64_t n, int d,
           float p, float inv_p, int sqrt_post, cudaStream_t stream) {
  const int64_t q_tiles = (nq + Geo<F>::BQ - 1) / Geo<F>::BQ;
  const int64_t blocks = q_tiles * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  groupmin_elementwise_kernel<F, GROUPMIN><<<(unsigned)blocks, NT, 0, stream>>>(
      (const float*)q, (const float*)x, (const float*)pad, (float*)out, nq, n, d, p, inv_p, sqrt_post,
      q_tiles);
  return (int)cudaGetLastError();
}

template <int F>
int launch_form(int groupmin, const void* q, const void* x, const void* pad, void* out, int64_t nq,
                int64_t n, int d, float p, float inv_p, int sqrt_post, cudaStream_t stream) {
  return groupmin ? launch<F, true>(q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, stream)
                  : launch<F, false>(q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, stream);
}

}  // namespace

extern "C" {

// form: 0 L1, 1 LINF, 2 LP, 3 JS; groupmin: 1 for the group mins f32[Q, N/128],
// 0 for the distances f32[Q, N]; inv_p: 1/p as the caller rounds it (LP);
// sqrt_post: JS's metric post. Launches on `stream` and returns
// cudaGetLastError(): a launch the card refuses never runs, and only this
// code reports it.
int tk_elementwise(int form, int groupmin, const void* q, const void* x, const void* pad, void* out,
                   long long nq, long long n, int d, float p, float inv_p, int sqrt_post, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d % BK != 0 || (groupmin && n % BN != 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case L1: return launch_form<L1>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
    case LINF: return launch_form<LINF>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
    case LP:
      if (!(p > 0.f)) return (int)cudaErrorInvalidValue;
      return launch_form<LP>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
    case JS: return launch_form<JS>(groupmin, q, x, pad, out, nq, n, d, p, inv_p, sqrt_post, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiling of a form, for counting its instructions an element pair:
// out = {TQ, TR, KU (k steps in one pass of the inner loop), BQ}.
int tk_elementwise_geometry(int form, int* out) {
  auto put = [out](int tq, int tr, int ku, int bq) {
    out[0] = tq, out[1] = tr, out[2] = ku, out[3] = bq;
    return 0;
  };
  switch (form) {
    case L1: return put(Geo<L1>::TQ, Geo<L1>::TR, Geo<L1>::KU, Geo<L1>::BQ);
    case LINF: return put(Geo<LINF>::TQ, Geo<LINF>::TR, Geo<LINF>::KU, Geo<LINF>::BQ);
    case LP: return put(Geo<LP>::TQ, Geo<LP>::TR, Geo<LP>::KU, Geo<LP>::BQ);
    case JS: return put(Geo<JS>::TQ, Geo<JS>::TR, Geo<JS>::KU, Geo<JS>::BQ);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
