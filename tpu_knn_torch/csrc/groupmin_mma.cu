// Pass 1 of the exact two-pass kNN scan on Hopper's tensor cores: the int8,
// bf16x3 ("high") and bf16 tiers of the fused distance + 128-row group min.
//
// Replaces the int8, high and bfloat16 tiers of
// tpu_knn/ops/pallas_scan.py:fused_groupmin (kernel body _kernel_t: int8
// at :111-117, bfloat16 at :118-119, high at :120-127). For q [Q, D],
// x [N, D], q_term f32[Q] and x_term f32[N] each entry point writes
//
//     out[i, g] = min_{r in [128 g, 128 g + 128)} (scale * dot(q_i, x_r) + x_term[r]) + q_term[i]
//
// as f32[Q, N/128], like csrc/groupmin.cu (the f32 tier); the [Q, N]
// distance block never reaches device memory. The dot of each tier:
//
//   int8      q, x int8; warp-level IMMA mma.sync m16n8k32 s8.s8 -> s32,
//             exact. float(dot) is exact (|dot| <= D * 2^14 < 2^24), so the
//             result is bit-equal to the plain f32 product of the cast values.
//   bfloat16  q, x f32, rounded to bf16 on load; one mma.sync m16n8k16
//             bf16 -> f32 pass: hi(q) . hi(x).
//   bf16x3    q, x f32 split on load into hi = bf16(v) and lo = bf16(v - hi);
//             three passes hi.hi, hi.lo, lo.hi into ONE f32 accumulator
//             (the TPU's hi.hi + (hi.lo + lo.hi); lo.lo is omitted).
//
// Tensor-core accumulation is not sequential round-to-nearest f32: the
// products of one mma are exact, but they and the running sum are aligned
// to the largest and truncated (Fasi, Higham, Mikaitis and Pranesh,
// "Numerical behavior of NVIDIA tensor cores", PeerJ CS 7:e330, 2021). The
// certificate's accumulation slack in methods/seq_search.py (_pass1_eps)
// counts the truncations this kernel makes, not the TPU's RN additions.
//
// What bounds it on an H100: the tensor cores do 128 x 128 x D MACs per
// block (x3 for bf16x3) while the block reads a 128-query tile and one
// 128-row group from L2/HBM, 2*128*D elements; the int8 and bf16 rates
// (1,979 and 989 dense TFLOP/s) are far above what warp-level mma.sync from
// a single-buffered shared tile reaches, so the bound is instruction issue
// and shared-memory/L2 latency. The design keeps it simple first: each of
// the 256 threads (8 warps, 2 along queries x 4 along rows) owns a 64 x 32
// warp tile of 4 x 4 mma tiles, 64 accumulators a thread, with ONE
// accumulator even for bf16x3 so the tile fits the register file. D is
// walked in chunks of 16 32-bit words a row (64 int8 or 32 bf16 values),
// staged through shared memory with a row stride of 20 words (4 x odd), so
// the fragment loads of a warp hit 32 distinct banks. The next chunk is
// fetched into registers while the current one computes; the f32 -> bf16
// split happens once per element on its way into shared memory. wgmma, TMA
// and a deeper pipeline are for a later change.
//
// Contract (checked by the Python wrapper, tpu_knn_torch/ops/groupmin.py):
// contiguous tensors on one device, 16-byte aligned, N % 128 == 0;
// D % 16 == 0 for int8, D % 8 == 0 for the bf16 tiers (a chunk past D is
// zero-filled). Q may be ragged: rows past Q load zeros and are not written.
// Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Tier { I8 = 0, BF16X3 = 1, BF16 = 2 };

constexpr int BQ = 128;          // queries per block
constexpr int BN = 128;          // corpus rows per block: one group
constexpr int NT = 256;          // threads per block: 8 warps
constexpr int KW = 16;           // 32-bit words per row in one k-chunk
constexpr int SW = KW + 4;       // shared row stride in words (4 x odd: conflict-free)
constexpr int WQ = 64;           // warp tile: queries
constexpr int WN = 32;           // warp tile: corpus rows
constexpr int MT = WQ / 16;      // mma tiles along queries
constexpr int NTL = WN / 8;      // mma tiles along rows

__device__ __forceinline__ void mma_i8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 in one word, element k in the low half (the mma operand order)
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 k0, __nv_bfloat16 k1) {
  return (uint32_t)__bfloat16_as_ushort(k0) | ((uint32_t)__bfloat16_as_ushort(k1) << 16);
}

// hi = bf16(v), lo = bf16(v - float(hi)); v - float(hi) is exact in f32
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
}

// f32 float4 (4 consecutive k) -> two words of hi and two of lo
__device__ __forceinline__ void stage_f4(uint32_t* hi_row, uint32_t* lo_row, int w, float4 v,
                                         bool with_lo) {
  __nv_bfloat16 h0, h1, h2, h3, l0, l1, l2, l3;
  split(v.x, h0, l0);
  split(v.y, h1, l1);
  split(v.z, h2, l2);
  split(v.w, h3, l3);
  *reinterpret_cast<uint2*>(hi_row + w) = make_uint2(pack2(h0, h1), pack2(h2, h3));
  if (with_lo) *reinterpret_cast<uint2*>(lo_row + w) = make_uint2(pack2(l0, l1), pack2(l2, l3));
}

template <int TIER>
struct Traits;
template <>
struct Traits<I8> {
  using Acc = int;
  static constexpr int LOADS = BQ * KW / 4 / NT;  // uint4 of one operand per thread: 2
};
template <>
struct Traits<BF16X3> {
  using Acc = float;
  static constexpr int LOADS = BQ * KW * 2 / 4 / NT;  // float4 of one operand per thread: 4
};
template <>
struct Traits<BF16> {
  using Acc = float;
  static constexpr int LOADS = BQ * KW * 2 / 4 / NT;
};

template <int TIER>
__device__ __forceinline__ void groupmin_body(const void* __restrict__ qv, const void* __restrict__ xv,
                                              const float* __restrict__ q_term,
                                              const float* __restrict__ x_term, float* __restrict__ out,
                                              int64_t nq, int64_t n_groups, int d, float scale,
                                              int64_t q_tiles) {
  using Acc = typename Traits<TIER>::Acc;
  constexpr int LOADS = Traits<TIER>::LOADS;
  constexpr int NARR = TIER == BF16X3 ? 4 : 2;
  __shared__ __align__(16) uint32_t sm[NARR * BQ * SW];
  __shared__ float red[BN / WN][BQ];
  uint32_t* qh = sm;                // q (int8 words or bf16 hi) [BQ][SW]
  uint32_t* xh = sm + BQ * SW;      // x, likewise [BN][SW]
  uint32_t* ql = sm + (NARR - 2) * BQ * SW;  // bf16x3: lo halves (aliases qh otherwise, unused)
  uint32_t* xl = sm + (NARR - 1) * BQ * SW;

  const int64_t bid = blockIdx.x;
  const int64_t q0 = (bid % q_tiles) * BQ;
  const int64_t grp = bid / q_tiles;
  const int64_t r0 = grp * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wq = warp >> 2;  // 0..1: query half
  const int wn = warp & 3;   // 0..3: row quarter
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group

  // loader: element v = tid + NT*i of each operand's chunk; row and column
  // in units of the load vector (16 bytes)
  constexpr int VPR = TIER == I8 ? KW / 4 : KW / 2;  // vectors per row: 4 uint4 or 8 float4
  constexpr int VW = TIER == I8 ? 16 : 4;            // elements per vector
  uint4 qreg[LOADS], xreg[LOADS];                    // raw 16-byte vectors in flight
  const int kchunk = KW * (TIER == I8 ? 4 : 2);      // elements of one chunk
  const int nchunks = (d + kchunk - 1) / kchunk;
  const int esz = TIER == I8 ? 1 : 4;                // bytes per element

  auto fetch = [&](int kc) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int v = tid + NT * i;
      const int row = v / VPR;
      const int col = kc * kchunk + (v % VPR) * VW;
      const bool in_d = col < d;
      const bool q_ok = in_d && q0 + row < nq;
      const char* qp = static_cast<const char*>(qv) + ((q0 + row) * (int64_t)d + col) * esz;
      const char* xp = static_cast<const char*>(xv) + ((r0 + row) * (int64_t)d + col) * esz;
      qreg[i] = q_ok ? __ldg(reinterpret_cast<const uint4*>(qp)) : make_uint4(0, 0, 0, 0);
      xreg[i] = in_d ? __ldg(reinterpret_cast<const uint4*>(xp)) : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int v = tid + NT * i;
      const int row = v / VPR;
      const int c = v % VPR;
      if constexpr (TIER == I8) {
        *reinterpret_cast<uint4*>(qh + row * SW + c * 4) = qreg[i];
        *reinterpret_cast<uint4*>(xh + row * SW + c * 4) = xreg[i];
      } else {
        const float4 qf = *reinterpret_cast<const float4*>(&qreg[i]);
        const float4 xf = *reinterpret_cast<const float4*>(&xreg[i]);
        stage_f4(qh + row * SW, ql + row * SW, c * 2, qf, TIER == BF16X3);
        stage_f4(xh + row * SW, xl + row * SW, c * 2, xf, TIER == BF16X3);
      }
    }
  };

  Acc acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  fetch(0);
  for (int kc = 0; kc < nchunks; ++kc) {
    stage();
    __syncthreads();
    if (kc + 1 < nchunks) fetch(kc + 1);  // in flight while this chunk computes
#pragma unroll
    for (int kw = 0; kw < KW; kw += 8) {  // one mma k-step: 8 words (32 int8 / 16 bf16)
      uint32_t bh[NTL][2], bl[NTL][2];
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int b = (wn * WN + j * 8 + g) * SW + kw + t;
        bh[j][0] = xh[b];
        bh[j][1] = xh[b + 4];
        if (TIER == BF16X3) {
          bl[j][0] = xl[b];
          bl[j][1] = xl[b + 4];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int a = (wq * WQ + i * 16 + g) * SW + kw + t;
        uint32_t ah[4] = {qh[a], qh[a + 8 * SW], qh[a + 4], qh[a + 8 * SW + 4]};
        uint32_t al[4];
        if (TIER == BF16X3) {
          al[0] = ql[a];
          al[1] = ql[a + 8 * SW];
          al[2] = ql[a + 4];
          al[3] = ql[a + 8 * SW + 4];
        }
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          if constexpr (TIER == I8) {
            mma_i8(acc[i][j], ah, bh[j]);
          } else {
            mma_bf16(acc[i][j], ah, bh[j]);
            if constexpr (TIER == BF16X3) {
              mma_bf16(acc[i][j], ah, bl[j]);
              mma_bf16(acc[i][j], al, bh[j]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this chunk before the next stage
  }

  // epilogue: accumulator e of tile (i, j) is query wq*64 + i*16 + g + 8*(e/2),
  // row wn*32 + j*8 + 2t + (e%2)
  float xt[NTL][2];
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) xt[j][e] = x_term[r0 + wn * WN + j * 8 + 2 * t + e];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = (float)acc[i][j][2 * h + e];  // exact for int8: |dot| < 2^24
          m = fminf(m, __fadd_rn(__fmul_rn(scale, s), xt[j][e]));
        }
      // the 4 lanes of one groupID hold the same query
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) red[wn][wq * WQ + i * 16 + h * 8 + g] = m;
    }
  }
  __syncthreads();
  if (tid < BQ) {
    float m = red[0][tid];
#pragma unroll
    for (int w = 1; w < BN / WN; ++w) m = fminf(m, red[w][tid]);
    const int64_t qi = q0 + tid;
    if (qi < nq) out[qi * n_groups + grp] = __fadd_rn(m, q_term[qi]);
  }
}

__global__ void __launch_bounds__(NT, 2)
groupmin_i8_kernel(const void* q, const void* x, const float* q_term, const float* x_term, float* out,
                   int64_t nq, int64_t n_groups, int d, float scale, int64_t q_tiles) {
  groupmin_body<I8>(q, x, q_term, x_term, out, nq, n_groups, d, scale, q_tiles);
}

__global__ void __launch_bounds__(NT, 1)
groupmin_bf16x3_kernel(const void* q, const void* x, const float* q_term, const float* x_term,
                       float* out, int64_t nq, int64_t n_groups, int d, float scale, int64_t q_tiles) {
  groupmin_body<BF16X3>(q, x, q_term, x_term, out, nq, n_groups, d, scale, q_tiles);
}

__global__ void __launch_bounds__(NT, 2)
groupmin_bf16_kernel(const void* q, const void* x, const float* q_term, const float* x_term, float* out,
                     int64_t nq, int64_t n_groups, int d, float scale, int64_t q_tiles) {
  groupmin_body<BF16>(q, x, q_term, x_term, out, nq, n_groups, d, scale, q_tiles);
}

using KernelFn = void (*)(const void*, const void*, const float*, const float*, float*, int64_t,
                          int64_t, int, float, int64_t);

int launch(KernelFn kern, int d_multiple, const void* q, const void* x, const void* q_term,
           const void* x_term, void* out, long long nq, long long n, int d, float scale, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (n % BN != 0 || d <= 0 || d % d_multiple != 0) return (int)cudaErrorInvalidValue;
  const int64_t q_tiles = (nq + BQ - 1) / BQ;
  const int64_t n_groups = n / BN;
  const int64_t blocks = q_tiles * n_groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(q, x, (const float*)q_term,
                                                          (const float*)x_term, (float*)out, nq,
                                                          n_groups, d, scale, q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError(): a launch the
// card refuses never runs, and only this code reports it.
int tk_groupmin_i8(const void* q, const void* x, const void* q_term, const void* x_term, void* out,
                   long long nq, long long n, int d, float scale, void* stream) {
  return launch(groupmin_i8_kernel, 16, q, x, q_term, x_term, out, nq, n, d, scale, stream);
}

int tk_groupmin_bf16x3(const void* q, const void* x, const void* q_term, const void* x_term,
                       void* out, long long nq, long long n, int d, float scale, void* stream) {
  return launch(groupmin_bf16x3_kernel, 8, q, x, q_term, x_term, out, nq, n, d, scale, stream);
}

int tk_groupmin_bf16(const void* q, const void* x, const void* q_term, const void* x_term, void* out,
                     long long nq, long long n, int d, float scale, void* stream) {
  return launch(groupmin_bf16_kernel, 8, q, x, q_term, x_term, out, nq, n, d, scale, stream);
}

const char* tk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
