// Pass 1 of the exact two-pass kNN scan: fused f32 distance + 128-row group min.
//
// Replaces the float32 tier of tpu_knn/ops/pallas_scan.py:fused_groupmin
// (kernel body _kernel_t, the shipped "x" layout, :128-135); the int8 tier
// is in groupmin_wgmma_i8.cu, high and bfloat16 in groupmin_wgmma.cu. It is
// also the certificate's per-block f32 redo of the reduced tiers. For
// q f32[Q, D], x f32[N, D], q_term f32[Q] and x_term f32[N] it writes
//
//     out[i, g] = min_{r in [128 g, 128 g + 128)} (scale * <q_i, x_r> + x_term[r]) + q_term[i]
//
// as f32[Q, N/128]. The [Q, N] distance block never reaches device memory.
// Adding q_term after the min gives the same value as adding it inside:
// rounding of a + c is monotone in a.
//
// What bounds it on an H100: FP32 FFMA issue. Every product is an IEEE f32
// fused multiply-add (no tensor cores: TF32 would break the exact tier).
// Each block owns a 128-query x 128-row (one group) tile and walks D in steps
// of 8 through double-buffered shared memory, so each corpus element loaded
// from device memory feeds BQ = 128 FMAs: about 2 * BQ / 4 = 64 FLOP per corpus
// byte, well above the card's ~20 FLOP/byte balance point for FP32. Blocks are
// ordered query-tile fastest, so the few query tiles that read one corpus group
// run together and the group comes from HBM once; the query matrix stays in L2.
// Each of the 256 threads keeps an 8 x 8 register tile of accumulators. The
// epilogue takes each thread's min over its 8 rows, then a shuffle min across
// the 16 threads that share a query.
//
// Contract (checked by the Python wrapper, tpu_knn_torch/ops/groupmin.py):
// contiguous f32 tensors on one device, 16-byte aligned, N % 128 == 0,
// D % 8 == 0. Q may be ragged: rows past Q load zeros and are not written.
// Offsets are 64-bit: N * D and Q * N / 128 exceed 2^31 at realistic sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;  // queries per block
constexpr int BN = 128;  // corpus rows per block: one group
constexpr int BK = 8;    // depth of one shared-memory stage
constexpr int NT = 256;  // threads per block: 16 x 16, each 8 queries x 8 rows

__device__ __forceinline__ void stage(float (*qs)[BQ], float (*xs)[BN], int row, int col,
                                      float4 qv, float4 xv) {
  qs[col + 0][row] = qv.x;
  qs[col + 1][row] = qv.y;
  qs[col + 2][row] = qv.z;
  qs[col + 3][row] = qv.w;
  xs[col + 0][row] = xv.x;
  xs[col + 1][row] = xv.y;
  xs[col + 2][row] = xv.z;
  xs[col + 3][row] = xv.w;
}

__global__ void __launch_bounds__(NT, 2)
groupmin_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    const float* __restrict__ q_term, const float* __restrict__ x_term,
                    float* __restrict__ out, int64_t nq, int64_t n_groups, int d,
                    float scale, int64_t q_tiles) {
  // [stage][k][query or row]: transposed so a thread's 4 neighbouring
  // queries (rows) at one k are one 16-byte shared load
  __shared__ __align__(16) float qs[2][BK][BQ];
  __shared__ __align__(16) float xs[2][BK][BN];

  const int64_t bid = blockIdx.x;
  const int64_t q0 = (bid % q_tiles) * BQ;
  const int64_t g = bid / q_tiles;
  const int64_t r0 = g * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // row slot
  const int ty = tid >> 4;  // query slot

  // loader: thread tid brings one float4 of the q tile and one of the x tile
  const int lrow = tid >> 1;
  const int lcol = (tid & 1) * 4;
  const bool q_ok = q0 + lrow < nq;
  const float* qp = q + (q_ok ? q0 + lrow : 0) * (int64_t)d + lcol;
  const float* xp = x + (r0 + lrow) * (int64_t)d + lcol;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 qv = q_ok ? __ldg(reinterpret_cast<const float4*>(qp)) : zero4;
  float4 xv = __ldg(reinterpret_cast<const float4*>(xp));
  stage(qs[0], xs[0], lrow, lcol, qv, xv);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += BK) {
    const bool more = k0 + BK < d;
    if (more) {  // fetch the next stage while this one computes
      qv = q_ok ? __ldg(reinterpret_cast<const float4*>(qp + k0 + BK)) : zero4;
      xv = __ldg(reinterpret_cast<const float4*>(xp + k0 + BK));
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&qs[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&qs[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&xs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&xs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // the other stage was last read before the previous barrier
      stage(qs[buf ^ 1], xs[buf ^ 1], lrow, lcol, qv, xv);
      __syncthreads();
      buf ^= 1;
    }
  }

  float xt[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) xt[j] = x_term[r0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4)];

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float m = __fadd_rn(__fmul_rn(scale, acc[i][0]), xt[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) m = fminf(m, __fadd_rn(__fmul_rn(scale, acc[i][j]), xt[j]));
    // the 16 threads sharing these queries are one half-warp (lanes tx)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const int64_t qi = q0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (tx == 0 && qi < nq) out[qi * n_groups + g] = __fadd_rn(m, q_term[qi]);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(): a launch the card
// refuses never runs, and only this code reports it.
int tk_groupmin_f32(const void* q, const void* x, const void* q_term, const void* x_term,
                    void* out, long long nq, long long n, int d, float scale, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (n % BN != 0 || d <= 0 || d % BK != 0) return (int)cudaErrorInvalidValue;
  const int64_t q_tiles = (nq + BQ - 1) / BQ;
  const int64_t n_groups = n / BN;
  const int64_t blocks = q_tiles * n_groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  groupmin_f32_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)x, (const float*)q_term, (const float*)x_term, (float*)out,
      nq, n_groups, d, scale, q_tiles);
  return (int)cudaGetLastError();
}

const char* tk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
