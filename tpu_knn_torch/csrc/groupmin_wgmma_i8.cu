// Pass 1 of the exact two-pass kNN scan on Hopper's warpgroup tensor cores:
// the int8 tier of the fused distance + 128-row group min (l2sqr_sift).
//
// Replaces the int8 tier of tpu_knn/ops/pallas_scan.py (fused_groupmin,
// kernel body _kernel_t, int8 at :111-117). For q int8[Q, D], x int8[N, D],
// q_term f32[Q] and x_term f32[N] the entry point writes
//
//     out[i, g] = min_{r in [128 g, 128 g + 128)} (scale * dot(q_i, x_r) + x_term[r]) + q_term[i]
//
// as f32[Q, N/128]; the [Q, N] distance block never reaches device memory.
// The dot is an exact s32 sum (wgmma m64n128k32 s8.s8 -> s32), converted to
// f32 exactly while |dot| <= D * 2^14 <= 2^24 (D <= 1024), so the result is
// bit-equal to the plain f32 product of the cast values. The multiply by
// scale and the addition of x_term are rounded separately, as in the plain
// version; where scale is a power of two the product is exact and one fused
// multiply-add gives the same bits (an instance chosen on the host).
//
// What bounds it on an H100: 2*Q*N*D int8 operations on the tensor cores
// (1,979 TOP/s dense): 0.267 ms at Q=2048, N=1M, D=128, against 0.04 ms to
// read x once from HBM. So it is bound by operations -- and, per output
// element of the [Q, N] block, by a convert, a multiply-add and a min on the
// CUDA cores: three instructions for every 128 multiply-adds of the tensor
// cores, so at D=128 the epilogue takes the SM about as long as the
// products. Measured on an H100 SXM at 700 W (tools/groupmin_ablation.py,
// PERF.md): a warpgroup's own products and epilogue do not overlap (a warp
// waits at its wgmma until the tensor core has taken it, and ptxas
// serializes every wgmma of a warpgroup that reads one accumulator set
// while another is in flight, remark C7514), and the two parts of different
// warpgroups add up rather than overlap: the products and the ring alone
// take 0.6 of the kernel's time, the epilogue's arithmetic 0.3 to 0.4. The
// design follows groupmin_wgmma.cu (the bf16x3 and bf16 tiers) with a wider
// resident tile and without its second accumulator set:
//
//  * A prologue kernel copies the queries once per call into a scratch
//    image in global memory, laid out as the exact shared-memory tiles wgmma
//    reads: 64 queries x 128 k per tile, 128-byte rows with the 128B
//    swizzle, zeros past Q and past D.
//  * The main kernel is persistent: one CTA per SM walks a contiguous range
//    of corpus tiles of NWG x NG x 128 rows (two consumer warpgroups with
//    two groups each, 512 rows, while that fits; else one group each; else
//    one warpgroup). A tile is read once from global memory, swizzled into
//    shared memory and stays resident while every query tile streams past.
//    An int8 group is a quarter of bf16x3's bytes, so four groups fit where
//    bf16x3 holds two: each 8 KB query stage from L2 feeds four groups.
//  * A producer warpgroup (its spare registers given to the consumers with
//    setmaxnreg): one lane streams the query image through a ring of 8 KB
//    stages with 1-D cp.async.bulk copies completing on mbarriers. At
//    D <= 128 two corpus tiles fit (DB), and its other three warps copy the
//    next tile into the second buffer while the consumers compute on the
//    first; otherwise the consumers copy each tile themselves between tiles.
//  * A consumer warpgroup's step is one query tile against its NG groups:
//    per 128-k slab one wgmma group of NG chains of up to 4 k-steps, group g
//    into its own 64 s32 accumulators, the chains issued in turns (a wgmma
//    that adds to the accumulators of the one before it waits for them, so
//    two chains fill each other's gaps); then wgmma.wait_group 0, the last
//    stage handed back, and the NG epilogues, while the other warpgroup's
//    products keep the tensor cores busy. A slab's stage goes back to the
//    producer as soon as the next slab is committed and it has completed,
//    so two ring stages suffice at any D.
//  * K chunks: when not even one group's slabs fit (D > 1664), one
//    warpgroup keeps kc slabs of the tile at a time, every query tile
//    streams past each chunk in turn, and between chunks a query tile's s32
//    accumulators wait in a per-CTA spill in global memory (scratch).
//    Integer sums are exact in any order, so any D % 16 == 0 runs.
//  * Epilogue in registers: float(acc) (exact), scale * . + x_term, four
//    running mins a thread, two shfl_xor steps across the quad, + q_term,
//    every min the NaN-carrying one of the other two sources (min_nan.cuh:
//    an inf row term gives NaN here too; it times equal to fminf),
//    one store per (query, group). x_term lies in shared memory in the order
//    a thread reads it, four values a load without bank conflicts; of its
//    first group a thread keeps its 32 values in registers while the tile is
//    resident (of both groups: slower, the registers run out). q_term is
//    loaded at the epilogue's start and added at its end: a load in flight
//    at a wgmma fence or wait holds the warp for the load's latency.
//
// Contract (checked by the Python wrapper, tpu_knn_torch/ops/groupmin.py):
// contiguous tensors on one device, q and x int8 and 16-byte aligned,
// N % 128 == 0, D % 16 == 0 (any width: see K chunks above); a scratch of
// tk_groupmin_i8_scratch_bytes. Q may be ragged: rows past Q are zeros in
// the image and are not written. Offsets are 64-bit. Launches on the given
// stream, allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "min_nan.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int QT = 64;          // queries per query tile (wgmma M)
constexpr int KS = 128;         // k per slab: one 128-byte swizzle row of int8
constexpr int SLAB = QT * 128;  // bytes of one query tile's slab: one ring stage
constexpr int MAX_STAGES = 8;
constexpr int MAX_THREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup

struct Args {
  const int8_t* x;
  const float* q_term;
  const float* x_term;
  float* out;
  const uint8_t* qimg;
  int* spill;  // K chunks: each CTA's accumulators between chunks, [CTA][q_tiles][16][128] int4
  int64_t nq, n, n_groups, n_tiles;
  int d, q_tiles, slabs, ksteps, stages, nwg;
  int kc;  // slabs of the corpus tile resident at once: all of them, or a K chunk
  float scale;
};

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma and its wait
__device__ __forceinline__ void fence_operand(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, int8 in, s32 accumulate; both
// operands K-major in shared memory (the integer form has no transpose and
// no input scale)
__device__ __forceinline__ void wgmma_m64n128_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// N k-steps of one slab of a query tile with NG groups of the corpus tile
// (16 KB apart), group g into acc[g], as one committed wgmma group. A wgmma
// that adds to the accumulators of the one before it starts only when that
// one has written them, so the NG chains are issued in turns. The fence,
// the wgmmas and the commit stand in one basic block: with a branch around
// each wgmma, or between them and the commit, ptxas puts a warpgroup.arrive
// before every one (remark C7519).
template <int N, int NG>
__device__ __forceinline__ void wgmma_slab(int (&acc)[NG][64], uint32_t qa, uint32_t xa, int accumulate) {
#pragma unroll
  for (int g = 0; g < NG; ++g) fence_operand(acc[g]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      wgmma_m64n128_s8(acc[g], sdesc(qa + kk * 32), sdesc(xa + g * 128 * 128 + kk * 32), accumulate | kk);
  wgmma_commit();
}

// the slab's k-steps, 1 to 4 of them, chosen outside the chain
template <int NG>
__device__ __forceinline__ void wgmma_slab_n(int (&acc)[NG][64], uint32_t qa, uint32_t xa, int accumulate, int ks) {
  if (ks >= 4)
    wgmma_slab<4, NG>(acc, qa, xa, accumulate);
  else if (ks == 3)
    wgmma_slab<3, NG>(acc, qa, xa, accumulate);
  else if (ks == 2)
    wgmma_slab<2, NG>(acc, qa, xa, accumulate);
  else
    wgmma_slab<1, NG>(acc, qa, xa, accumulate);
}

// the s32 dot as f32: exact while |dot| <= 2^24
__device__ __forceinline__ float cvt(int s) { return __int2float_rn(s); }

// scale * dot + x_term with the plain version's bits: two roundings, or one
// fused multiply-add where the product is exact (scale a power of two)
template <bool POW2>
__device__ __forceinline__ float term(float scale, int s, float xt) {
  if (POW2) return __fmaf_rn(scale, cvt(s), xt);
  return __fadd_rn(__fmul_rn(scale, cvt(s)), xt);
}

// where row r of a group keeps its x_term in shared memory. Thread tq of a
// quad holds the accumulator columns 8 j + 2 tq + e (j < 16, e < 2) and
// reads them four a load, columns j = 2 j2 and 2 j2 + 1: [j2][tq][j & 1][e],
// so that the four threads of a quad read 64 consecutive bytes (no bank
// conflict; laid out [tq][j][e], the four read the same banks, and the loads
// took more of the shared-memory pipe than the products' operands)
__device__ __forceinline__ int xt_pos(int r) {
  const int j = r >> 3;
  return (j >> 1) * 16 + ((r & 7) >> 1) * 4 + (j & 1) * 2 + (r & 1);
}

// of how many of its warpgroup's groups a consumer thread keeps the x_term
// of its columns in registers (32 a group) while the corpus tile is
// resident; the others' it reads from shared memory in every epilogue
constexpr int XREG = 1;

// The query image: [q_tiles][slabs][64 rows][128 bytes], each (tile, slab)
// one ring stage of 8 KB. Zeros past Q and past D.
__global__ void __launch_bounds__(256) image_queries_kernel(const int8_t* __restrict__ q,
                                                            uint8_t* __restrict__ img, int64_t nq, int d,
                                                            int slabs, int64_t q_tiles) {
  const int ch = slabs * (KS / 16);  // 16-byte chunks of a row in the image
  const int64_t total = q_tiles * QT * ch;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = idx / ch;
    const int c = (int)(idx % ch);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < nq && c * 16 < d) v = __ldg(reinterpret_cast<const uint4*>(q + row * d + c * 16));
    uint8_t* dst = img + ((row / QT) * slabs + c / 8) * (int64_t)SLAB + swz((int)(row % QT), c % 8);
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// Slabs [s0, s1) of corpus tile [r0, r0 + bn) -> shared memory
// [s1 - s0 slabs][bn rows][128 bytes], swizzled, zeros past N and in the
// last k-step past D; with the first slab, x_term -> xt_s (xt_pos order
// within each group). Consecutive threads take consecutive 16-byte chunks
// of a row and then of the next row, and each thread keeps U loads in
// flight before it stores.
template <int U>
__device__ __forceinline__ void stage_corpus(const Args& a, int64_t r0, int bn, int s0, int s1, uint8_t* xs,
                                             float* xt_s, int tid, int nthreads) {
  const int c0 = 8 * s0;
  const int c1 = 8 * s1 < 2 * a.ksteps ? 8 * s1 : 2 * a.ksteps;  // chunks the k-steps of these slabs read
  const int cw = c1 - c0;
  const int64_t rows = a.n - r0 < bn ? a.n - r0 : bn;
  const int total = bn * cw;
  for (int base = tid; base < total; base += U * nthreads) {
    uint4 v[U];
    int dst[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * nthreads;
      v[u] = make_uint4(0, 0, 0, 0);
      dst[u] = -1;
      if (idx < total) {
        const int r = idx / cw;
        const int c = c0 + (idx - r * cw);
        dst[u] = ((c >> 3) - s0) * bn * 128 + swz(r, c & 7);
        if (r < rows && c * 16 < a.d)
          v[u] = __ldg(reinterpret_cast<const uint4*>(a.x + (r0 + r) * a.d + c * 16));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (dst[u] >= 0) *reinterpret_cast<uint4*>(xs + dst[u]) = v[u];
  }
  if (s0 == 0)
    for (int r = tid; r < bn; r += nthreads) xt_s[(r & ~127) + xt_pos(r & 127)] = r < rows ? a.x_term[r0 + r] : 0.f;
}

// NG: groups of the corpus tile a consumer warpgroup owns, with an
// accumulator set each.
// DB: two corpus tile buffers; the producer warpgroup's warps 1-3 copy the
// next tile into one while the consumers compute on the other. Otherwise
// the consumers copy each tile themselves between tiles.
// CHUNK: K chunks (one consumer warpgroup, no DB); its own instance, so that
// the chunk loop and the spill take no registers from the resident modes.
// POW2: scale is a power of two, so scale * dot + x_term is one FFMA.
template <int NG, bool DB, bool CHUNK, bool POW2>
__global__ void __launch_bounds__(MAX_THREADS, 1) groupmin_i8_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // shared memory: [corpus tile x NB][ring of stages][x_term x NB][barriers]
  constexpr int NB = DB ? 2 : 1;
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const sm = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  const int bn = 128 * NG * a.nwg;
  const int tile_bytes = a.kc * bn * 128;
  uint8_t* const xs0 = sm;
  uint8_t* const ring = xs0 + NB * tile_bytes;
  float* const xt0 = reinterpret_cast<float*>(ring + a.stages * SLAB);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(xt0 + NB * bn);
  const uint32_t ring_a = smem_u32(ring);
  // query ring: full and empty per stage; corpus buffers: full and empty per buffer
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * a.stages;
  const uint32_t xfull0 = empty0 + 8 * a.stages, xempty0 = xfull0 + 8 * NB;
  const int nct = 128 * a.nwg;  // consumer threads
  constexpr int NSTAGERS = 96;  // producer warps 1-3

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * a.nwg);  // lane 0 of every consumer warp
    }
    for (int b = 0; DB && b < NB; ++b) {
      mbar_init(xfull0 + 8 * b, NSTAGERS);
      mbar_init(xempty0 + 8 * b, 4 * a.nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this CTA's corpus tiles: a contiguous range, so that its consecutive
  // tiles fill consecutive output columns while they are still in L2
  const int64_t t_begin = blockIdx.x * a.n_tiles / gridDim.x;
  const int64_t t_end = (blockIdx.x + 1) * a.n_tiles / gridDim.x;

  if (threadIdx.x >= nct) {  // the producer warpgroup: one lane streams the query image
    // registers go to the consumers; with DB the stagers keep enough for
    // their loads in flight (128 * 56 + 256 * 224 <= 384 * 168)
    if constexpr (DB)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == nct) {
      int st = 0;
      uint32_t phase = 0;
      // the consumers' order: per K chunk (one unless CHUNK) every query tile's slabs
      for (int64_t t = t_begin; t < t_end; ++t)
        for (int s0 = 0; s0 < a.slabs; s0 += a.kc)
          for (int qt = 0; qt < a.q_tiles; ++qt)
            for (int s = s0; s < s0 + a.kc && s < a.slabs; ++s) {
              mbar_wait(empty0 + 8 * st, phase ^ 1);
              mbar_expect_tx(full0 + 8 * st, SLAB);
              bulk_g2s(ring_a + st * SLAB, a.qimg + ((int64_t)qt * a.slabs + s) * SLAB, SLAB, full0 + 8 * st);
              if (++st == a.stages) st = 0, phase ^= 1;
            }
    } else if (DB && threadIdx.x >= nct + 32) {
      int i = 0;
      for (int64_t t = t_begin; t < t_end; ++t, ++i) {
        const int b = i & 1;
        mbar_wait(xempty0 + 8 * b, ((i >> 1) & 1) ^ 1);
        stage_corpus<4>(a, t * bn, bn, 0, a.slabs, xs0 + b * tile_bytes, xt0 + b * bn, threadIdx.x - nct - 32,
                        NSTAGERS);
        fence_proxy_async();
        mbar_arrive(xfull0 + 8 * b);
      }
    }
    return;
  }

  if constexpr (DB)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int w = tid >> 7;  // consumer warpgroup: groups w * NG .. w * NG + NG - 1 of the corpus tile
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  int st = 0;  // the producer's stage sequence: stage and phase
  uint32_t phase = 0;
  int acc[NG][64];

  int i_tile = 0;
  for (int64_t t = t_begin; t < t_end; ++t, ++i_tile) {
    const int b = DB ? i_tile & 1 : 0;
    uint8_t* const xs = xs0 + b * tile_bytes;
    float* const xt_s = xt0 + b * bn;
    // slabs [s0, s1) of this tile into shared memory, by the consumers
    auto stage = [&](int s0, int s1) {
      consumer_sync(nct);  // every warpgroup is done with what was there
      stage_corpus<8>(a, t * bn, bn, s0, s1, xs, xt_s, tid, nct);
      fence_proxy_async();
      consumer_sync(nct);
    };
    if constexpr (DB)
      mbar_wait(xfull0 + 8 * b, (i_tile >> 1) & 1);
    else if constexpr (!CHUNK)
      stage(0, a.slabs);

    const int64_t grp0 = t * (NG * a.nwg) + w * NG;
    const uint32_t xb = smem_u32(xs) + w * NG * 128 * 128;  // this warpgroup's rows in each slab's block
    const float4* const xt = reinterpret_cast<const float4*>(xt_s + w * NG * 128) + tq;
    // x_term of this thread's columns of its first XR groups, for the whole tile
    constexpr int XR = CHUNK ? 0 : (XREG < NG ? XREG : NG);
    [[maybe_unused]] float4 xr[XR > 0 ? XR : 1][8];
#pragma unroll
    for (int gi = 0; gi < XR; ++gi)
#pragma unroll
      for (int j2 = 0; j2 < 8; ++j2) xr[gi][j2] = xt[32 * gi + 4 * j2];

    // the mins of group gi for query tile qt: the thread holds rows g and
    // g + 8 of its warp's 16, columns 8 j + 2 tq and + 1 for j < 16
    auto epilogue = [&](int (&acc)[64], int qt, int gi) {
      fence_operand(acc);
      const int64_t grp = grp0 + gi;
      // q_term of the thread's two rows, loaded here and added at the end: a
      // load in flight at a wgmma fence or wait holds the warp for its latency
      const int64_t qi = (int64_t)qt * QT + warp * 16 + g;
      const float qv0 = qi < a.nq ? __ldg(a.q_term + qi) : 0.f;
      const float qv1 = qi + 8 < a.nq ? __ldg(a.q_term + qi + 8) : 0.f;
      const float inf = __int_as_float(0x7f800000);
      float m0 = inf, m1 = inf, n0 = inf, n1 = inf;  // rows g (m0, n0) and g + 8 (m1, n1)
#pragma unroll
      for (int j2 = 0; j2 < 8; ++j2) {
        // x_term of columns j = 2 j2 (x, y) and 2 j2 + 1 (z, w)
        const float4 v = gi < XR ? xr[gi < XR ? gi : 0][j2] : xt[32 * gi + 4 * j2];
        m0 = min_nan(m0, term<POW2>(a.scale, acc[8 * j2 + 0], v.x));
        n0 = min_nan(n0, term<POW2>(a.scale, acc[8 * j2 + 1], v.y));
        m1 = min_nan(m1, term<POW2>(a.scale, acc[8 * j2 + 2], v.x));
        n1 = min_nan(n1, term<POW2>(a.scale, acc[8 * j2 + 3], v.y));
        m0 = min_nan(m0, term<POW2>(a.scale, acc[8 * j2 + 4], v.z));
        n0 = min_nan(n0, term<POW2>(a.scale, acc[8 * j2 + 5], v.w));
        m1 = min_nan(m1, term<POW2>(a.scale, acc[8 * j2 + 6], v.z));
        n1 = min_nan(n1, term<POW2>(a.scale, acc[8 * j2 + 7], v.w));
      }
      m0 = min_nan(m0, n0);
      m1 = min_nan(m1, n1);
      // the 4 lanes of a quad hold the same two rows
      m0 = min_nan(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = min_nan(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = min_nan(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = min_nan(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      if (grp < a.n_groups && tq == 0) {
        if (qi < a.nq) a.out[qi * a.n_groups + grp] = __fadd_rn(m0, qv0);
        if (qi + 8 < a.nq) a.out[(qi + 8) * a.n_groups + grp] = __fadd_rn(m1, qv1);
      }
    };
    // K chunks: a query tile's accumulators between two chunks, in this
    // CTA's spill (exact: the next chunk's products add to the same s32 sums)
    auto spill_at = [&](int qt) {
      return reinterpret_cast<int4*>(a.spill) + ((int64_t)blockIdx.x * a.q_tiles + qt) * 16 * nct + tid;
    };
    auto spill_store = [&](int (&acc)[64], int qt) {
      fence_operand(acc);
      int4* const p = spill_at(qt);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        __stcg(p + i * nct, make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
    };
    auto spill_load = [&](int (&acc)[64], int qt) {
      const int4* const p = spill_at(qt);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int4 v = __ldcg(p + i * nct);
        acc[4 * i] = v.x, acc[4 * i + 1] = v.y, acc[4 * i + 2] = v.z, acc[4 * i + 3] = v.w;
      }
    };
    // The products of slabs [s0, s1) of query tile qt with this warpgroup's
    // groups into acc (the tile resident from slab s0 on), each slab a wgmma
    // group on one ring stage. Once a slab is committed, wait_group 1 means
    // the slab before it has completed, and that slab's stage goes back to
    // the producer. Returns the last slab's stage, still held.
    auto products = [&](int qt, int s0, int s1) {
      if (CHUNK && s0 > 0) spill_load(acc[0], qt);
      int held = 0;  // the stage of the slab before this one
      for (int s = s0; s < s1; ++s) {
        mbar_wait(full0 + 8 * st, phase);
        wgmma_slab_n<NG>(acc, ring_a + st * SLAB, xb + (s - s0) * bn * 128, s, a.ksteps - 4 * s);
        if (s > s0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * held);
        }
        held = st;
        if (++st == a.stages) st = 0, phase ^= 1;
      }
      return held;
    };
    // every query tile streams past slabs [s0, s1) of the tile: its
    // products, then its epilogues (or, before the last K chunk, its spill)
    // while the other warpgroup's products keep the tensor cores busy
    auto chunk = [&](int s0, int s1) {
      for (int qt = 0; qt < a.q_tiles; ++qt) {
        const int held = products(qt, s0, s1);
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty0 + 8 * held);
        if (!CHUNK || s1 == a.slabs) {
#pragma unroll
          for (int gi = 0; gi < NG; ++gi) epilogue(acc[gi], qt, gi);
        } else {
          spill_store(acc[0], qt);
        }
      }
    };
    if constexpr (CHUNK) {
      for (int s0 = 0; s0 < a.slabs; s0 += a.kc) {
        const int s1 = s0 + a.kc < a.slabs ? s0 + a.kc : a.slabs;
        stage(s0, s1);
        chunk(s0, s1);
      }
    } else {
      chunk(0, a.slabs);
    }
    if (DB && lane == 0) mbar_arrive(xempty0 + 8 * b);  // this buffer's products and x_term are read
  }
}

struct Plan {
  int nwg, ng, stages, kc;
  bool db;
  size_t smem;
};

// Shared memory's layout decided once, here. The first resident tile that
// fits the opt-in shared memory with room for its ring, widest first: two
// consumer warpgroups with two groups each (a 512-row tile) and two corpus
// buffers and four or more stages (D <= 128 on an H100), the same with one
// buffer and two or more stages (D <= 384), two warpgroups with one group
// each (D <= 768), one warpgroup (D <= 1664). When not even one group fits,
// one warpgroup keeps a K chunk of kc slabs: the fewest chunks, of balanced
// size. False if not one slab fits.
bool plan(int slabs, int smem_optin, Plan& p) {
  const size_t stage = SLAB, optin = (size_t)smem_optin, bars = 16 * (MAX_STAGES + 2);
  auto fill = [&](int nwg, int ng, int kc, bool db, size_t fixed) {
    const size_t st = (optin - fixed) / stage;
    p.nwg = nwg;
    p.ng = ng;
    p.kc = kc;
    p.db = db;
    p.stages = st < MAX_STAGES ? (int)st : MAX_STAGES;
    p.smem = fixed + p.stages * stage;
    return true;
  };
  const int tiles[4][3] = {{2, 2, 2}, {2, 2, 1}, {2, 1, 1}, {1, 1, 1}};  // warpgroups, groups each, buffers
  for (const auto& c : tiles) {
    const size_t bn = 128 * (size_t)c[0] * c[1];
    const size_t fixed = 1024 + c[2] * ((size_t)slabs * bn * 128 + bn * 4) + bars;
    if (fixed + (c[2] == 2 ? 4 : 2) * stage <= optin) return fill(c[0], c[1], slabs, c[2] == 2, fixed);
  }
  const size_t slab = 128 * 128, base = 1024 + 128 * 4 + bars;
  if (base + 2 * stage + slab > optin) return false;
  const int most = (int)((optin - base - 2 * stage) / slab);
  const int chunks = (slabs + most - 1) / most;
  const int kc = (slabs + chunks - 1) / chunks;
  return fill(1, 1, kc, false, base + kc * slab);
}

// This device's plan for nq queries of dimension d, and the scratch it
// needs: the query image, then with K chunks each CTA's spill of 32 KB per
// query tile (both 8 KB multiples, so aligned).
cudaError_t setup(long long nq, int d, Plan& p, int& sms, int64_t& image_bytes, int64_t& scratch) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int slabs = (d + KS - 1) / KS;
  if (!plan(slabs, optin, p)) return cudaErrorInvalidValue;
  const int64_t q_tiles = (nq + QT - 1) / QT;
  image_bytes = q_tiles * slabs * SLAB;
  scratch = image_bytes + (p.kc < slabs ? (int64_t)sms * q_tiles * 16 * 128 * p.nwg * 16 : 0);
  return cudaSuccess;
}

// scale * dot is exact, so that one FFMA rounds as the multiply and the add do
bool is_pow2(float scale) {
  int e = 0;
  return frexpf(fabsf(scale), &e) == 0.5f && e > -60 && e < 60;
}

typedef void (*Kernel)(const Args);

template <bool POW2>
Kernel kernel_for(const Plan& p, int slabs) {
  if (p.kc < slabs) return groupmin_i8_kernel<1, false, true, POW2>;
  if (p.ng == 1) return groupmin_i8_kernel<1, false, false, POW2>;
  return p.db ? groupmin_i8_kernel<2, true, false, POW2> : groupmin_i8_kernel<2, false, false, POW2>;
}

int launch(const void* q, const void* x, const void* q_term, const void* x_term, void* out, long long nq,
           long long n, int d, float scale, void* scratch, long long scratch_len, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (n % 128 != 0 || d <= 0 || d % 16 != 0) return (int)cudaErrorInvalidValue;
  Plan p;
  int sms = 0;
  int64_t image_bytes = 0, need = 0;
  cudaError_t e = setup(nq, d, p, sms, image_bytes, need);
  if (e != cudaSuccess) return (int)e;
  if (scratch_len < need) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const int8_t*)x;
  a.q_term = (const float*)q_term;
  a.x_term = (const float*)x_term;
  a.out = (float*)out;
  a.qimg = (const uint8_t*)scratch;
  a.spill = reinterpret_cast<int*>((uint8_t*)scratch + image_bytes);
  a.nq = nq;
  a.n = n;
  a.n_groups = n / 128;
  a.nwg = p.nwg;
  a.kc = p.kc;
  a.n_tiles = (a.n_groups + p.nwg * p.ng - 1) / (p.nwg * p.ng);
  a.d = d;
  a.q_tiles = (int)((nq + QT - 1) / QT);
  a.slabs = (d + KS - 1) / KS;
  a.ksteps = (d + 31) / 32;
  a.stages = p.stages;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;

  const int64_t chunks = (int64_t)a.q_tiles * QT * a.slabs * (KS / 16);
  const int64_t image_blocks = (chunks + 255) / 256;
  image_queries_kernel<<<(unsigned)(image_blocks < 8LL * sms ? image_blocks : 8LL * sms), 256, 0, s>>>(
      (const int8_t*)q, (uint8_t*)scratch, nq, d, a.slabs, a.q_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Kernel kern = is_pow2(scale) ? kernel_for<true>(p, a.slabs) : kernel_for<false>(p, a.slabs);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = a.n_tiles < sms ? a.n_tiles : sms;
  kern<<<(unsigned)grid, 128 * p.nwg + 128, p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch a call with nq queries of dimension d needs on the
// current device: the query image (8 KB per 64 queries per 128 k) and, when
// D takes K chunks, the accumulators' spill (32 KB per 64 queries per SM).
// -1 if the device cannot be queried or not one slab fits its shared memory.
long long tk_groupmin_i8_scratch_bytes(long long nq, int d) {
  Plan p;
  int sms = 0;
  int64_t image_bytes = 0, scratch = 0;
  if (nq <= 0 || d <= 0) return 0;
  return setup(nq, d, p, sms, image_bytes, scratch) == cudaSuccess ? scratch : -1;
}

// The plan a call at dimension d and this scale takes on the current
// device, as out[6] = {consumer warpgroups, groups each, ring stages, slabs
// resident at once, two corpus buffers, power-of-two scale}; the total
// number of slabs is ceil(d / 128). 0, or the CUDA error.
int tk_groupmin_i8_plan(int d, float scale, int* out) {
  Plan p;
  int sms = 0;
  int64_t image_bytes = 0, scratch = 0;
  cudaError_t e = d > 0 ? setup(1, d, p, sms, image_bytes, scratch) : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const int v[6] = {p.nwg, p.ng, p.stages, p.kc, (int)p.db, (int)is_pow2(scale)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// Launches the query image copy and the group-min kernel on `stream` and
// returns cudaGetLastError(): a launch the card refuses never runs, and
// only this code reports it.
int tk_groupmin_i8(const void* q, const void* x, const void* q_term, const void* x_term, void* out,
                   long long nq, long long n, int d, float scale, void* scratch, long long scratch_len,
                   void* stream) {
  return launch(q, x, q_term, x_term, out, nq, n, d, scale, scratch, scratch_len, stream);
}

const char* tk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
