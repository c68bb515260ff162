// Pass 1 of the exact two-pass kNN scan on Hopper's warpgroup tensor cores:
// the bf16x3 ("high") and bf16 tiers of the fused distance + 128-row group min.
//
// Replaces the bfloat16 and high tiers of tpu_knn/ops/pallas_scan.py
// (fused_groupmin, kernel body _kernel_t: bfloat16 at :118-119, high at
// :120-127). For q f32[Q, D], x f32[N, D], q_term f32[Q] and x_term f32[N]
// each entry point writes
//
//     out[i, g] = min_{r in [128 g, 128 g + 128)} (scale * dot(q_i, x_r) + x_term[r]) + q_term[i]
//
// as f32[Q, N/128]; the [Q, N] distance block never reaches device memory.
// With hi = bf16(v) and lo = bf16(v - hi), the dot of each tier is
//
//   bf16x3    hi.hi + hi.lo + lo.hi (lo.lo omitted), all three products
//             issued per k-step into ONE f32 accumulator;
//   bfloat16  hi.hi.
//
// What bounds it on an H100: 2*Q*N*D multiply-adds per pass on the bf16
// tensor cores (989 TFLOP/s dense): 1.60 ms for bf16x3 and 0.53 ms for bf16
// at Q=2048, N=1M, D=128, against 0.18 ms to read x once from HBM. So it is
// bound by operations, and by what keeps the tensor cores fed: operands in
// shared memory in the layout wgmma reads, no per-tile f32 reload, and an
// epilogue that overlaps the next tile's products. The design:
//
//  * A prologue kernel splits the queries once per call into a scratch
//    image in global memory (hi, and lo for bf16x3), laid out as the exact
//    shared-memory tiles wgmma reads: 64 queries x 64 k per tile and part,
//    128-byte rows with the 128B swizzle, zeros past Q and past D.
//  * The main kernel is persistent: one CTA per SM walks a contiguous range
//    of corpus tiles of NWG x 128 rows (NWG = 2 consumer warpgroups, 1 when
//    D is too wide for two groups to fit). Each tile is read once from
//    global memory, split once into bf16 hi/lo in shared memory, swizzled,
//    and stays resident while every query tile streams past. A contiguous
//    range keeps a CTA's writes to one output row close together in time.
//  * A producer warpgroup (its spare registers given to the consumers with
//    setmaxnreg): one lane streams the query image through a ring of stages
//    (one 64 x 64-k slab of every part per stage) with 1-D cp.async.bulk
//    copies completing on mbarriers; no tensor map is needed. When two
//    corpus tiles fit in shared memory (DB: bf16 at D <= 192 with two
//    groups, bf16x3 only at small D), its other three warps split the next
//    tile into the second buffer while the consumers compute on the first;
//    otherwise the consumers split each tile themselves between tiles.
//  * K chunks: when not even one group's split slabs fit (bf16x3 above
//    D = 384, bf16 above D = 832), one warpgroup keeps kc slabs of the
//    tile at a time, and every query tile streams past each chunk in turn.
//    Between chunks a query tile's f32 accumulators wait in a per-CTA
//    spill in global memory (scratch), and the next chunk's products add
//    to the same values, so the k order and the sums are those of one
//    resident tile; any D % 8 == 0 runs. At gist-960's width this takes
//    ~28% (bf16x3) and ~18% (bf16) of the bound, under half the f32 time.
//  * Consumer warpgroup w owns group w of the corpus tile: wgmma m64n128k16
//    bf16 -> f32 with queries on M and the group's 128 rows on N, K = D in
//    k-steps of 16 (a partial last step reads zero-filled shared memory).
//    Two accumulator sets alternate between query tiles: when the ring
//    holds two query tiles' stages (HOLD), a tile's slabs are one wgmma
//    group and the previous tile's epilogue runs while all of it is in
//    flight; otherwise each slab is a group of its own.
//  * Epilogue in registers: scale * acc + x_term (from shared memory) per
//    column, the min over the thread's 32 columns of each row, two
//    shfl_xor steps across the quad, + q_term (loaded before the products
//    are issued, so its latency is hidden), one store per (query, group).
//
// Measured on an H100 SXM at its 700 W power limit, 1M x 128 rows and
// Q=2048 (tpu_knn_torch/tools/groupmin_ablation.py; PERF.md): the power
// cap holds the SM clock at 1590-1725 MHz under this kernel, below the
// 1830 MHz at which the 989 TFLOP/s peak is rated. bf16x3 takes ~67% of
// its bound and is bound by its products (half of them: 0.68 of the time;
// the products and the query ring alone: 0.75). bf16 takes ~47%: the
// products and ring alone take 0.74 of its time, about two thirds of the
// tensor peak at the running clock, and the epilogue is not all hidden
// behind them (a quarter of its arithmetic: 0.85 of the time; no stores:
// 0.97). The second corpus buffer (DB) is worth 14% to bf16.
//
// Summation: each output takes passes * ceil(D/16) wgmma k16 steps into one
// accumulator, in k order, hi.hi then hi.lo then lo.hi within a step: the
// same count and order of tensor-core additions as the mma.sync kernel it
// replaced, so the certificate's accumulation slack (_acc_slack in
// methods/seq_search.py) is unchanged.
//
// Contract (checked by the Python wrapper, tpu_knn_torch/ops/groupmin.py):
// contiguous f32 tensors on one device, 16-byte aligned, N % 128 == 0,
// D % 8 == 0 (any width: see K chunks above); a scratch of
// tk_groupmin_wgmma_scratch_bytes.
// Q may be ragged: rows past Q are zeros in the image and are not written.
// Offsets are 64-bit. Launches on the given stream, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int QT = 64;          // queries per query tile (wgmma M)
constexpr int KS = 64;          // k per slab: one 128-byte swizzle row of bf16
constexpr int SLAB = QT * 128;  // bytes of one part of one query tile's slab
constexpr int MAX_STAGES = 8;
constexpr int MAX_THREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup

struct Args {
  const float* x;
  const float* q_term;
  const float* x_term;
  float* out;
  const uint8_t* qimg;
  float* spill;  // K chunks: each CTA's accumulators between chunks, [CTA][q_tiles][16][128] float4
  int64_t nq, n, n_groups, n_tiles;
  int d, q_tiles, slabs, ksteps, stages, nwg;
  int kc;  // slabs of the corpus tile resident at once: all of them, or a K chunk
  float scale;
};

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma and its wait
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// two bf16 in one word, the lower k in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 k0, __nv_bfloat16 k1) {
  return (uint32_t)__bfloat16_as_ushort(k0) | ((uint32_t)__bfloat16_as_ushort(k1) << 16);
}

// 8 consecutive f32 -> 8 bf16 hi (and 8 bf16 lo = bf16(v - hi), exact in f32)
__device__ __forceinline__ void split8(float4 a, float4 b, uint4& hi, uint4& lo) {
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  __nv_bfloat16 h[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = __float2bfloat16_rn(v[i]);
    l[i] = __float2bfloat16_rn(__fsub_rn(v[i], __bfloat162float(h[i])));
  }
  hi = make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]), pack2(h[6], h[7]));
  lo = make_uint4(pack2(l[0], l[1]), pack2(l[2], l[3]), pack2(l[4], l[5]), pack2(l[6], l[7]));
}

// The query image: [q_tiles][slabs][PX parts][64 rows][128 bytes], each
// (tile, slab) one ring stage of PX * 8 KB. Zeros past Q and past D.
template <int PX>
__global__ void __launch_bounds__(256) split_queries_kernel(const float* __restrict__ q,
                                                            uint8_t* __restrict__ img, int64_t nq, int d,
                                                            int slabs, int64_t q_tiles) {
  const int ch = slabs * (KS / 8);  // 16-byte chunks of a row in the image
  const int64_t total = q_tiles * QT * ch;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = idx / ch;
    const int c = (int)(idx % ch);
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (row < nq && c * 8 < d) {
      const float4* p = reinterpret_cast<const float4*>(q + row * d + c * 8);
      v0 = __ldg(p);
      v1 = __ldg(p + 1);
    }
    uint4 hi, lo;
    split8(v0, v1, hi, lo);
    uint8_t* dst = img + ((row / QT) * slabs + c / 8) * (int64_t)(PX * SLAB) + swz((int)(row % QT), c % 8);
    *reinterpret_cast<uint4*>(dst) = hi;
    if (PX == 2) *reinterpret_cast<uint4*>(dst + SLAB) = lo;
  }
}

// Slabs [s0, s1) of corpus tile [r0, r0 + bn) -> shared memory
// [s1 - s0 slabs][PX parts][bn rows][128 bytes], swizzled, zeros past N and
// in the last k-step past D; with the first slab, x_term -> xt_s.
// 16 threads cover 16 consecutive 32-byte chunks of a row (coalesced), and
// each thread keeps U rows' loads in flight before it splits and stores.
template <int PX, int U>
__device__ __forceinline__ void stage_corpus(const Args& a, int64_t r0, int bn, int s0, int s1, uint8_t* xs,
                                             float* xt_s, int tid, int nthreads) {
  const int ksteps_end = 4 * s1 < a.ksteps ? 4 * s1 : a.ksteps;
  const int ch = ksteps_end * 2;  // 16-byte chunks the k-steps of these slabs read
  const int rstep = nthreads >> 4;
  const int64_t rows = a.n - r0 < bn ? a.n - r0 : bn;
  for (int c = 8 * s0 + (tid & 15); c < ch; c += 16) {
    const bool in_d = c * 8 < a.d;
    for (int rb = tid >> 4; rb < bn; rb += U * rstep) {
      float4 v[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + u * rstep;
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in_d && r < rows) {
          const float4* p = reinterpret_cast<const float4*>(a.x + (r0 + r) * a.d + c * 8);
          v[u][0] = __ldg(p);
          v[u][1] = __ldg(p + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + u * rstep;
        if (r < bn) {
          uint4 hi, lo;
          split8(v[u][0], v[u][1], hi, lo);
          uint8_t* dst = xs + ((c >> 3) - s0) * PX * bn * 128 + swz(r, c & 7);
          *reinterpret_cast<uint4*>(dst) = hi;
          if (PX == 2) *reinterpret_cast<uint4*>(dst + bn * 128) = lo;
        }
      }
    }
  }
  if (s0 == 0)
    for (int r = tid; r < bn; r += nthreads) xt_s[r] = r < rows ? a.x_term[r0 + r] : 0.f;
}

// HOLD: the ring has room for two query tiles' stages, so a query tile's
// slabs go into one wgmma group and the previous tile's epilogue overlaps
// all of them; otherwise each slab is a group that holds one stage.
// DB: two corpus tile buffers; the producer warpgroup's warps 1-3 split the
// next tile into one while the consumers compute on the other. Otherwise
// the consumers split each tile themselves between tiles.
// CHUNK: K chunks (neither HOLD nor DB); its own instance, so that the
// chunk loop and the spill take no registers from the resident modes.
template <int PX, bool HOLD, bool DB, bool CHUNK>
__global__ void __launch_bounds__(MAX_THREADS, 1) groupmin_wgmma_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // shared memory: [corpus tile x NB][ring of stages][x_term x NB][barriers]
  constexpr int NB = DB ? 2 : 1;
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const sm = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  const int bn = 128 * a.nwg;
  constexpr uint32_t STAGE = PX * SLAB;
  const int tile_bytes = a.kc * PX * bn * 128;
  uint8_t* const xs0 = sm;
  uint8_t* const ring = xs0 + NB * tile_bytes;
  float* const xt0 = reinterpret_cast<float*>(ring + a.stages * STAGE);
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
    // their loads in flight (128 * 72 + 256 * 208 <= 384 * 168)
    if constexpr (DB)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
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
              mbar_expect_tx(full0 + 8 * st, STAGE);
              bulk_g2s(ring_a + st * STAGE, a.qimg + ((int64_t)qt * a.slabs + s) * STAGE, STAGE,
                       full0 + 8 * st);
              if (++st == a.stages) st = 0, phase ^= 1;
            }
    } else if (DB && threadIdx.x >= nct + 32) {
      int i = 0;
      for (int64_t t = t_begin; t < t_end; ++t, ++i) {
        const int b = i & 1;
        mbar_wait(xempty0 + 8 * b, ((i >> 1) & 1) ^ 1);
        stage_corpus<PX, 4>(a, t * bn, bn, 0, a.slabs, xs0 + b * tile_bytes, xt0 + b * bn,
                            threadIdx.x - nct - 32, NSTAGERS);
        fence_proxy_async();
        mbar_arrive(xfull0 + 8 * b);
      }
    }
    return;
  }

  if constexpr (DB)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int w = tid >> 7;  // consumer warpgroup = group of the corpus tile
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  int st = 0;          // the producer's stage sequence: stage and phase
  uint32_t phase = 0;
  // the stages read by the wgmma group still in flight: pend_n from pend on
  int pend = 0, pend_n = 0;
  float acc0[64], acc1[64];

  int i_tile = 0;
  for (int64_t t = t_begin; t < t_end; ++t, ++i_tile) {
    const int b = DB ? i_tile & 1 : 0;
    uint8_t* const xs = xs0 + b * tile_bytes;
    float* const xt_s = xt0 + b * bn;
    // slabs [s0, s1) of this tile into shared memory, by the consumers
    auto stage = [&](int s0, int s1) {
      consumer_sync(nct);  // every warpgroup is done with what was there
      stage_corpus<PX, 8>(a, t * bn, bn, s0, s1, xs, xt_s, tid, nct);
      fence_proxy_async();
      consumer_sync(nct);
    };
    if constexpr (DB)
      mbar_wait(xfull0 + 8 * b, (i_tile >> 1) & 1);
    else if constexpr (!CHUNK)
      stage(0, a.slabs);

    const int64_t grp = t * a.nwg + w;
    const bool live = grp < a.n_groups;
    const uint32_t xb = smem_u32(xs) + w * 128 * 128;  // this group's rows in each (slab, part) block

    auto release = [&]() {
      for (int i = 0, k = pend; i < pend_n; ++i, k = k + 1 == a.stages ? 0 : k + 1)
        if (lane == 0) mbar_arrive(empty0 + 8 * k);
      pend_n = 0;
    };
    // q_term of the thread's two rows of a query tile, loaded well before
    // the epilogue that adds it
    auto qterm = [&](int qt, float& v0, float& v1) {
      const int64_t qi = (int64_t)qt * QT + warp * 16 + g;
      v0 = qi >= 0 && qi < a.nq ? __ldg(a.q_term + qi) : 0.f;
      v1 = qi >= 0 && qi + 8 < a.nq ? __ldg(a.q_term + qi + 8) : 0.f;
    };
    auto epilogue = [&](float(&acc)[64], int qt, float qv0, float qv1) {
      fence_operand(acc);
      float m0 = __int_as_float(0x7f800000), m1 = m0;  // +inf: rows g and g + 8
      const float* xt = xt_s + w * 128 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(xt + 8 * j);
        m0 = fminf(m0, __fadd_rn(__fmul_rn(a.scale, acc[4 * j + 0]), v.x));
        m0 = fminf(m0, __fadd_rn(__fmul_rn(a.scale, acc[4 * j + 1]), v.y));
        m1 = fminf(m1, __fadd_rn(__fmul_rn(a.scale, acc[4 * j + 2]), v.x));
        m1 = fminf(m1, __fadd_rn(__fmul_rn(a.scale, acc[4 * j + 3]), v.y));
      }
      // the 4 lanes of a quad hold the same two rows
      m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      const int64_t qi = (int64_t)qt * QT + warp * 16 + g;
      if (live && tq == 0) {
        if (qi < a.nq) a.out[qi * a.n_groups + grp] = __fadd_rn(m0, qv0);
        if (qi + 8 < a.nq) a.out[(qi + 8) * a.n_groups + grp] = __fadd_rn(m1, qv1);
      }
    };
    // K chunks: a query tile's accumulators between two chunks, in this
    // CTA's spill (exact: the next chunk's products add to the same f32 values)
    auto spill_at = [&](int qt) {
      return reinterpret_cast<float4*>(a.spill) + ((int64_t)blockIdx.x * a.q_tiles + qt) * 16 * nct + tid;
    };
    auto spill_store = [&](float(&acc)[64], int qt) {
      fence_operand(acc);
      float4* const p = spill_at(qt);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        __stcg(p + i * nct, make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
    };
    auto spill_load = [&](float(&acc)[64], int qt) {
      const float4* const p = spill_at(qt);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 v = __ldcg(p + i * nct);
        acc[4 * i] = v.x, acc[4 * i + 1] = v.y, acc[4 * i + 2] = v.z, acc[4 * i + 3] = v.w;
      }
    };
    // the products of slabs [s0, s1) of one query tile into acc (resident
    // from slab s0 on). Once a group is committed, wait_group 1 means every
    // earlier group has completed: their stages are released and `prev`
    // (the previous tile's epilogue or spill) runs while this tile's
    // products are in flight.
    auto run = [&](float(&acc)[64], int qt, int s0, int s1, auto&& prev) {
      [[maybe_unused]] const int first = st;
      float qv0, qv1;
      qterm(qt - 1, qv0, qv1);
      if (CHUNK && s0 > 0) spill_load(acc, qt);
      for (int s = s0; s < s1; ++s) {
        mbar_wait(full0 + 8 * st, phase);
        const uint32_t qa = ring_a + st * STAGE;
        const uint32_t xa = xb + (s - s0) * PX * bn * 128;
        const int ks = a.ksteps - 4 * s;
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          if (kk < ks) {
            const uint64_t ah = sdesc(qa + kk * 32), bh = sdesc(xa + kk * 32);
            wgmma_m64n128(acc, ah, bh, s | kk);
            if (PX == 2) {
              const uint64_t al = sdesc(qa + SLAB + kk * 32), bl = sdesc(xa + bn * 128 + kk * 32);
              wgmma_m64n128(acc, ah, bl, 1);
              wgmma_m64n128(acc, al, bh, 1);
            }
          }
        }
        if constexpr (!HOLD) {
          wgmma_commit();
          fence_operand(acc);
          wgmma_wait<1>();
          release();
          pend = st, pend_n = 1;
        }
        if (++st == a.stages) st = 0, phase ^= 1;
        if (!HOLD && s == s0) prev(qv0, qv1);
      }
      if constexpr (HOLD) {
        wgmma_commit();
        fence_operand(acc);
        wgmma_wait<1>();
        release();
        pend = first, pend_n = s1 - s0;
        prev(qv0, qv1);
      }
    };

    // every query tile streams past slabs [s0, s1) of the tile
    auto chunk = [&](int s0, int s1) {
      // a query tile's products are all in: its epilogue, or its spill until the next chunk
      auto finish = [&](float(&acc)[64], int qt, float v0, float v1) {
        if (!CHUNK || s1 == a.slabs)
          epilogue(acc, qt, v0, v1);
        else
          spill_store(acc, qt);
      };
      for (int qt = 0; qt < a.q_tiles; qt += 2) {
        run(acc0, qt, s0, s1, [&](float v0, float v1) {
          if (qt > 0) finish(acc1, qt - 1, v0, v1);
        });
        if (qt + 1 < a.q_tiles)
          run(acc1, qt + 1, s0, s1, [&](float v0, float v1) { finish(acc0, qt, v0, v1); });
      }
      float qv0, qv1;
      qterm(a.q_tiles - 1, qv0, qv1);
      wgmma_wait<0>();
      release();
      if (a.q_tiles & 1)
        finish(acc0, a.q_tiles - 1, qv0, qv1);
      else
        finish(acc1, a.q_tiles - 1, qv0, qv1);
    };
    if constexpr (CHUNK) {
      // each chunk's products are done (waited for) before the next is staged
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
  int nwg, stages, kc;
  bool db;
  size_t smem;
};

// Shared memory's layout decided once, here. The first that fits the
// opt-in shared memory, in this order: two consumer warpgroups (a 256-row
// corpus tile) before one; two corpus buffers before one; room for two
// query tiles' stages (HOLD) before two stages. When not even one
// warpgroup's whole tile fits with two stages (bf16x3 above D = 384, bf16
// above D = 832 on an H100), one warpgroup keeps a K chunk of kc slabs:
// the fewest chunks, of balanced size. False if not one slab fits.
bool plan(int slabs, int px, int smem_optin, Plan& p) {
  const size_t stage = (size_t)px * SLAB, optin = (size_t)smem_optin;
  auto fill = [&](int nwg, int kc, bool db, size_t fixed) {
    const size_t st = (optin - fixed) / stage;
    p.nwg = nwg;
    p.kc = kc;
    p.db = db;
    p.stages = st < MAX_STAGES ? (int)st : MAX_STAGES;
    p.smem = fixed + p.stages * stage;
    return true;
  };
  for (int nwg = 2; nwg >= 1; --nwg) {
    const size_t bn = 128 * (size_t)nwg;
    for (int nb = 2; nb >= 1; --nb) {
      const size_t fixed = 1024 + nb * ((size_t)slabs * px * bn * 128 + bn * 4) + 16 * (MAX_STAGES + 2);
      for (int need : {2 * slabs, 2}) {
        if (nb == 2 && need < 2 * slabs) continue;  // two buffers only with HOLD
        if (fixed + need * stage <= optin) return fill(nwg, slabs, nb == 2, fixed);
      }
    }
  }
  const size_t slab = (size_t)px * 128 * 128, base = 1024 + 128 * 4 + 16 * (MAX_STAGES + 2);
  if (base + 2 * stage + slab > optin) return false;
  const int most = (int)((optin - base - 2 * stage) / slab);
  const int chunks = (slabs + most - 1) / most;
  const int kc = (slabs + chunks - 1) / chunks;
  return fill(1, kc, false, base + kc * slab);
}

// This device's plan for nq queries of dimension d, and the scratch it
// needs: the query image, then with K chunks each CTA's spill of 32 KB per
// query tile and consumer warpgroup (both 8 KB multiples, so aligned).
cudaError_t setup(long long nq, int d, int px, Plan& p, int& sms, int64_t& image_bytes, int64_t& scratch) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int slabs = (d + KS - 1) / KS;
  if (!plan(slabs, px, optin, p)) return cudaErrorInvalidValue;
  const int64_t q_tiles = (nq + QT - 1) / QT;
  image_bytes = q_tiles * slabs * px * SLAB;
  scratch = image_bytes + (p.kc < slabs ? (int64_t)sms * q_tiles * 16 * 128 * p.nwg * 16 : 0);
  return cudaSuccess;
}

template <int PX>
int launch(const void* q, const void* x, const void* q_term, const void* x_term, void* out, long long nq,
           long long n, int d, float scale, void* scratch, long long scratch_len, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (n % 128 != 0 || d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  Plan p;
  int sms = 0;
  int64_t image_bytes = 0, need = 0;
  cudaError_t e = setup(nq, d, PX, p, sms, image_bytes, need);
  if (e != cudaSuccess) return (int)e;
  if (scratch_len < need) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.q_term = (const float*)q_term;
  a.x_term = (const float*)x_term;
  a.out = (float*)out;
  a.qimg = (const uint8_t*)scratch;
  a.spill = reinterpret_cast<float*>((uint8_t*)scratch + image_bytes);
  a.nq = nq;
  a.n = n;
  a.n_groups = n / 128;
  a.nwg = p.nwg;
  a.kc = p.kc;
  a.n_tiles = (a.n_groups + p.nwg - 1) / p.nwg;
  a.d = d;
  a.q_tiles = (int)((nq + QT - 1) / QT);
  a.slabs = (d + KS - 1) / KS;
  a.ksteps = (d + 15) / 16;
  a.stages = p.stages;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;

  const int64_t chunks = (int64_t)a.q_tiles * QT * a.slabs * (KS / 8);
  const int64_t split_blocks = (chunks + 255) / 256;
  split_queries_kernel<PX><<<(unsigned)(split_blocks < 8LL * sms ? split_blocks : 8LL * sms), 256, 0, s>>>(
      (const float*)q, (uint8_t*)scratch, nq, d, a.slabs, a.q_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kern = p.db                       ? groupmin_wgmma_kernel<PX, true, true, false>
              : a.kc < a.slabs               ? groupmin_wgmma_kernel<PX, false, false, true>
              : a.stages >= 2 * a.slabs      ? groupmin_wgmma_kernel<PX, true, false, false>
                                             : groupmin_wgmma_kernel<PX, false, false, false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = a.n_tiles < sms ? a.n_tiles : sms;
  kern<<<(unsigned)grid, 128 * p.nwg + 128, p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch a call with nq queries of dimension d needs on the
// current device: the split query image (16 KB per 64 queries per 64 k for
// bf16x3, 8 KB for bf16) and, when D takes K chunks, the accumulators'
// spill (32 KB per 64 queries per SM). -1 if the device cannot be queried
// or not one slab fits its shared memory.
long long tk_groupmin_wgmma_scratch_bytes(long long nq, int d, int bf16x3) {
  Plan p;
  int sms = 0;
  int64_t image_bytes = 0, scratch = 0;
  if (nq <= 0 || d <= 0) return 0;
  return setup(nq, d, bf16x3 ? 2 : 1, p, sms, image_bytes, scratch) == cudaSuccess ? scratch : -1;
}

// Each launches the query split and the group-min kernel on `stream` and
// returns cudaGetLastError(): a launch the card refuses never runs, and
// only this code reports it.
int tk_groupmin_bf16x3(const void* q, const void* x, const void* q_term, const void* x_term, void* out,
                       long long nq, long long n, int d, float scale, void* scratch, long long scratch_len,
                       void* stream) {
  return launch<2>(q, x, q_term, x_term, out, nq, n, d, scale, scratch, scratch_len, stream);
}

int tk_groupmin_bf16(const void* q, const void* x, const void* q_term, const void* x_term, void* out,
                     long long nq, long long n, int d, float scale, void* scratch, long long scratch_len,
                     void* stream) {
  return launch<1>(q, x, q_term, x_term, out, nq, n, d, scale, scratch, scratch_len, stream);
}

const char* tk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
