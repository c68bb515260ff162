// The pair kernel of groupmin_elementwise.cu (elementwise_pair_kernel, the
// batched epilogue at Cq > 1): its thread tile, its limits, and the tiling a
// launch takes, which pair_tiling picks on the host from Cq and K. No CUDA
// here: the kernel's source includes this file, and so can a host compiler
// (tests/test_torch_elementwise_pairs.py checks the tilings on the CPU).
#pragma once

#include <stdint.h>

// TQ queries x TR rows a thread, BK columns of D a shared-memory stage, at
// most LOADS 16-byte loads a thread a stage
constexpr int PAIR_TQ = 4, PAIR_TR = 4, PAIR_BK = 16, PAIR_LOADS = 4;
constexpr int PAIR_THREADS = 256;     // threads a block at most
constexpr int PAIR_SMEM = 96 * 1024;  // dynamic shared memory a block at most

// One launch's tiling: ny x nx threads an item tile, g items a block, qt x
// rt block tiles an item, the block's threads and its dynamic shared memory
// in bytes
struct PairTiling {
  int ny, nx, g, qt, rt, threads, smem;
};

// The shared memory of g items' tiles of ny x nx threads: two stages of their
// vector groups (4 vectors x BK + 1 columns), and as much again for JS's logs
constexpr int pair_smem_bytes(int g, int ny, int nx, bool logs) {
  return (logs ? 4 : 2) * (g * (ny * PAIR_TQ + nx * PAIR_TR) / 4) * (PAIR_BK + 1) * 16;
}

// Pair slots an SM computes while its share of the HBM rate brings one float:
// 64 L1 pairs a clock on its 128 FP32 lanes against 3.2 floats a clock (3.35
// TB/s over 132 SMs at 1.98 GHz; NVIDIA's H100 SXM data sheet)
constexpr int64_t PAIR_SLOTS_A_FLOAT = 20;

inline int64_t pair_up(int64_t n, int64_t m) { return (n + m - 1) / m; }

// The tiling of cq queries against k rows an item. An item's pairs are cut
// into qt x rt block tiles of ny x nx threads (even shares); a block holds g
// items' tiles side by side, within PAIR_THREADS threads that each issue at
// most LOADS loads a stage (threads past the item tiles only load) and
// PAIR_SMEM. Of the tilings that fit, the one whose blocks take an SM the
// least time a k step an item: their pair slots (every thread of the block,
// padding, idle lanes and load-only threads included, as they hold issue
// slots) or the item's cq + k floats from HBM, whichever is longer; on a tie
// the fewest block tiles, as each tile past the first reads the item's
// vectors again (from L2). This picks 6 x 6 threads and 5 items a block at
// 24 x 24, 10 x 10 and 2 items at 40 x 40, 27 x 9 threads and 3 block tiles
// at 108 x 108: the tilings timed on the card (PERF.md section 6).
inline PairTiling pair_tiling(int cq, int64_t k, bool logs) {
  constexpr int64_t VMAX = (int64_t)PAIR_LOADS * PAIR_THREADS / (PAIR_BK / 4);  // vectors a block stages
  const int64_t cols = pair_up(cq, PAIR_TQ), rows = pair_up(k, PAIR_TR);
  const int64_t floats = PAIR_SLOTS_A_FLOAT * (cq + k);
  PairTiling best{};
  int64_t best_slots = 0, best_g = 1;  // the cost: max(slots, floats g) / g
  for (int64_t qt = 1; qt <= cols; ++qt) {
    const int64_t ny = pair_up(cols, qt);
    if (qt > 1 && ny == pair_up(cols, qt - 1)) continue;  // the same tile as at qt - 1, in more blocks
    int64_t nx_max = PAIR_THREADS / ny;
    if ((VMAX - ny * PAIR_TQ) / PAIR_TR < nx_max) nx_max = (VMAX - ny * PAIR_TQ) / PAIR_TR;
    if (nx_max < 1) continue;
    const int64_t rt_min = pair_up(rows, nx_max);
    for (int64_t rt = rt_min; rt <= rt_min + 3 && rt <= rows; ++rt) {
      const int64_t nx = pair_up(rows, rt), per = ny * nx;
      for (int64_t g = per <= PAIR_THREADS ? PAIR_THREADS / per : 1; g >= 1; --g) {
        const int64_t vecs = g * (ny * PAIR_TQ + nx * PAIR_TR);
        const int64_t compute = pair_up(g * per, 32) * 32;
        const int64_t load = pair_up(pair_up(vecs * (PAIR_BK / 4), PAIR_LOADS), 32) * 32;
        const int64_t threads = compute > load ? compute : load;
        const int smem = pair_smem_bytes((int)g, (int)ny, (int)nx, logs);
        if (threads > PAIR_THREADS || smem > PAIR_SMEM) continue;
        const int64_t slots = qt * rt * threads * PAIR_TQ * PAIR_TR;
        const int64_t cost = slots > floats * g ? slots : floats * g;
        const int64_t best_cost = best_slots > floats * best_g ? best_slots : floats * best_g;
        // cost / g against best_cost / best_g, exactly
        if (best.ny == 0 || cost * best_g < best_cost * g ||
            (cost * best_g == best_cost * g && qt * rt < (int64_t)best.qt * best.rt)) {
          best = {(int)ny, (int)nx, (int)g, (int)qt, (int)rt, (int)threads, smem};
          best_slots = slots, best_g = g;
        }
        break;  // the most items a block that fit
      }
    }
  }
  return best;
}

// A tiling as the geometry entry reports it: {ny, nx, g, qt, rt, threads,
// smem, TQ, TR, BK}
inline void put_pair_tiling(const PairTiling& t, int* out) {
  out[0] = t.ny, out[1] = t.nx, out[2] = t.g, out[3] = t.qt, out[4] = t.rt, out[5] = t.threads;
  out[6] = t.smem, out[7] = PAIR_TQ, out[8] = PAIR_TR, out[9] = PAIR_BK;
}
