// Pass 1 of the exact two-pass kNN scan on Hopper's tensor cores: the int8
// tier of the fused distance + 128-row group min.
//
// Replaces the int8 tier of tpu_knn/ops/pallas_scan.py:fused_groupmin
// (kernel body _kernel_t, int8 at :111-117). For q int8[Q, D], x int8[N, D],
// q_term f32[Q] and x_term f32[N] the entry point writes
//
//     out[i, g] = min_{r in [128 g, 128 g + 128)} (scale * dot(q_i, x_r) + x_term[r]) + q_term[i]
//
// as f32[Q, N/128], like csrc/groupmin.cu (the f32 tier); the [Q, N]
// distance block never reaches device memory. The dot is warp-level IMMA
// mma.sync m16n8k32 s8.s8 -> s32, exact; float(dot) is exact (|dot| <=
// D * 2^14 < 2^24), so the result is bit-equal to the plain f32 product of
// the cast values. (The bf16x3 and bf16 tiers are csrc/groupmin_wgmma.cu.)
//
// What bounds it on an H100: the tensor cores do 128 x 128 x D MACs per
// block while the block reads a 128-query tile and one 128-row group from
// L2/HBM, 2*128*D bytes; the int8 rate (1,979 dense TOP/s) is far above what
// warp-level mma.sync from a single-buffered shared tile reaches, so the
// bound is instruction issue and shared-memory/L2 latency. The design keeps
// it simple first: each of the 256 threads (8 warps, 2 along queries x 4
// along rows) owns a 64 x 32 warp tile of 4 x 4 mma tiles, 64 accumulators a
// thread. D is walked in chunks of 16 32-bit words a row (64 int8 values),
// staged through shared memory with a row stride of 20 words (4 x odd), so
// the fragment loads of a warp hit 32 distinct banks. The next chunk is
// fetched into registers while the current one computes.
//
// Contract (checked by the Python wrapper, tpu_knn_torch/ops/groupmin.py):
// contiguous tensors on one device, 16-byte aligned, N % 128 == 0,
// D % 16 == 0. Q may be ragged: rows past Q load zeros and are not written.
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // queries per block
constexpr int BN = 128;          // corpus rows per block: one group
constexpr int NT = 256;          // threads per block: 8 warps
constexpr int KW = 16;           // 32-bit words per row in one k-chunk (64 int8)
constexpr int SW = KW + 4;       // shared row stride in words (4 x odd: conflict-free)
constexpr int WQ = 64;           // warp tile: queries
constexpr int WN = 32;           // warp tile: corpus rows
constexpr int MT = WQ / 16;      // mma tiles along queries
constexpr int NTL = WN / 8;      // mma tiles along rows
constexpr int LOADS = BQ * KW / 4 / NT;  // uint4 of one operand per thread: 2
constexpr int VPR = KW / 4;              // uint4 vectors per row of a chunk

__device__ __forceinline__ void mma_i8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NT, 2)
groupmin_i8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ x,
                   const float* __restrict__ q_term, const float* __restrict__ x_term,
                   float* __restrict__ out, int64_t nq, int64_t n_groups, int d, float scale,
                   int64_t q_tiles) {
  __shared__ __align__(16) uint32_t sm[2 * BQ * SW];
  __shared__ float red[BN / WN][BQ];
  uint32_t* qs = sm;             // q int8 words [BQ][SW]
  uint32_t* xs = sm + BQ * SW;   // x, likewise [BN][SW]

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

  // loader: vector v = tid + NT*i of each operand's chunk (16 bytes each)
  uint4 qreg[LOADS], xreg[LOADS];
  const int kchunk = KW * 4;  // int8 elements of one chunk
  const int nchunks = (d + kchunk - 1) / kchunk;

  auto fetch = [&](int kc) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int v = tid + NT * i;
      const int row = v / VPR;
      const int col = kc * kchunk + (v % VPR) * 16;
      const bool in_d = col < d;
      const bool q_ok = in_d && q0 + row < nq;
      const int8_t* qp = q + (q0 + row) * (int64_t)d + col;
      const int8_t* xp = x + (r0 + row) * (int64_t)d + col;
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
      *reinterpret_cast<uint4*>(qs + row * SW + c * 4) = qreg[i];
      *reinterpret_cast<uint4*>(xs + row * SW + c * 4) = xreg[i];
    }
  };

  int acc[MT][NTL][4];
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
    for (int kw = 0; kw < KW; kw += 8) {  // one mma k-step: 8 words (32 int8)
      uint32_t b[NTL][2];
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int o = (wn * WN + j * 8 + g) * SW + kw + t;
        b[j][0] = xs[o];
        b[j][1] = xs[o + 4];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int o = (wq * WQ + i * 16 + g) * SW + kw + t;
        const uint32_t a[4] = {qs[o], qs[o + 8 * SW], qs[o + 4], qs[o + 8 * SW + 4]};
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma_i8(acc[i][j], a, b[j]);
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
          const float s = (float)acc[i][j][2 * h + e];  // exact: |dot| < 2^24
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

int launch(const void* q, const void* x, const void* q_term, const void* x_term, void* out, long long nq,
           long long n, int d, float scale, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (n % BN != 0 || d <= 0 || d % 16 != 0) return (int)cudaErrorInvalidValue;
  const int64_t q_tiles = (nq + BQ - 1) / BQ;
  const int64_t n_groups = n / BN;
  const int64_t blocks = q_tiles * n_groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  groupmin_i8_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)x, (const float*)q_term, (const float*)x_term, (float*)out, nq,
      n_groups, d, scale, q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(): a launch the card
// refuses never runs, and only this code reports it.
int tk_groupmin_i8(const void* q, const void* x, const void* q_term, const void* x_term, void* out,
                   long long nq, long long n, int d, float scale, void* stream) {
  return launch(q, x, q_term, x_term, out, nq, n, d, scale, stream);
}

const char* tk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
