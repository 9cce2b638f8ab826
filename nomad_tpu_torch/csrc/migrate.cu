// Bounded-budget migration auction on Hopper (sm_90a).
//
// Replaces nomad_tpu/device/migrate.py:migrate_plan_kernel.
//
// One round, as the reference's while_loop body:
//  - every alloc a not moved yet prices each node n, gain = ((score[a, n]
//    - cur_score[a]) - move_cost[a]) - lam[n], and claims the first node
//    of the largest gain among those where the replacement fits on top
//    of the committed usage (used[n] + size[a] <= capacity[n] in every
//    dimension), a is eligible, n is not a's current node and gain > 0;
//  - each claimed node admits one claimant, the largest gain and then the
//    smallest alloc index;
//  - an exclusive prefix count of the claimed nodes in node order admits
//    the first (budget - moves) of them: each admitted node's winner moves
//    there (dest, gains = its gain) and the node's usage grows by its size;
//  - on every node, usage += (admitted ? winner's size : 0) and lam += ETA
//    * max(claims - 1, 0), then lam = max(lam - ETA, 0) where nobody
//    claimed; rounds counts the rounds that had a claimant.
// The loop ends after `steps` rounds, after a round without a claimant
// (whose lam decay stands) or once moves reach the budget.
//
// What bounds it on the H100: the chain of rounds. A round reads the
// whole score and eligibility grid of the allocs still in place (5 bytes
// a cell: 1 GB at 20,000 allocs x 10,000 nodes, far past the 50 MB L2),
// so a pass costs rounds x (one streaming pass over the grid + two
// grid-wide barriers + the node update).
//
// Design: one cooperative launch of 512-thread blocks, as many as fit on
// the card at once (no more than there are groups of 32 allocs), looping
// over the rounds with a grid-wide barrier (an
// arrival counter and a generation word, spun on with atomics) after
// each of the two phases:
//  1. row pass: a block takes 32 allocs (two a warp) and walks the nodes
//     in tiles of 1,024, staging the tile's capacity, usage and price in
//     shared memory so that the 32 rows share one read of the node state;
//     each lane keeps its rows' best (gain, node), a warp reduction gives
//     each row's claim, and lane 0 resolves it with two integer atomics
//     on the claimed node: claims += 1, and a 64-bit max of (gain bits <<
//     32 | 0xFFFFFFFF - a). The gain of a claim is > 0, so its bits order
//     as the floats do: the max is the winner (largest gain, then
//     smallest a), exact in any order, and no float is reduced by atomics;
//  2. node pass, block 0: a block-wide ballot scan of (claims > 0) in node
//     order gives each claimed node its rank; the admitted winners commit
//     (dest, gains) and every node's usage and price update; the claim
//     words are zeroed for the next round. Admitted nodes number
//     min(claimed, budget - moves), so moves, rounds and progress follow
//     from the claimed count alone.
// State crossing blocks is read and written at L2 (__ldcg / __stcg): the
// SMs' L1 caches are not coherent.
//
// Numerics: separately rounded f32 ops in the reference's order and the
// build's -fmad=false; the price terms are exact (a power of two times a
// small integer). Scores are finite, as every caller gives them.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTile = 1024;  // nodes staged in shared memory at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEta = 0.125f;
constexpr long long kHeader = 4;  // barrier (2 words), progress, padding

struct Mig {
  const float4* capacity;     // [N]
  const float4* sizes;        // [A]
  const int32_t* cur;         // [A]
  const uint8_t* eligible;    // [A, N]
  const float* scores;        // [A, N]
  const float* cur_scores;    // [A]
  const float* move_cost;     // [A]
  int a, n, budget, steps;
  unsigned* barrier;          // [2]: arrivals, generation
  int32_t* progress;          // [1]
  unsigned long long* key;    // [N]: the round's best claim, 0 = none
  int32_t* claims;            // [N]
  float4* used;               // [N], used0 on entry
  float* lam;                 // [N], lam0 on entry
  int32_t* dest;              // [A], -1 on entry
  float* gains;               // [A], 0 on entry
  int32_t* moves;             // [1], 0 on entry
  int32_t* rounds;            // [1], 0 on entry
};

__device__ __forceinline__ bool before(float k, int r, float bk, int br) {
  return k > bk || (k == bk && r < br);
}

__device__ __forceinline__ void warp_argmax(float& k, int& r) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, k, off);
    const int orow = __shfl_xor_sync(kFull, r, off);
    if (before(ok, orow, k, r)) {
      k = ok;
      r = orow;
    }
  }
}

// Every block waits here until all have arrived; writes before the
// barrier are visible at L2 after it. The last block to arrive resets the
// count and bumps the generation the others poll (at L2, no atomic).
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = __ldcg(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (__ldcg(bar + 1) == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ bool fits(float4 u, float4 s, float4 cap) {
  return (__fadd_rn(u.x, s.x) <= cap.x) & (__fadd_rn(u.y, s.y) <= cap.y) &
         (__fadd_rn(u.z, s.z) <= cap.z) & (__fadd_rn(u.w, s.w) <= cap.w);
}

// Phase 1: each alloc still in place claims its best feasible node.
__device__ void row_pass(const Mig& c) {
  __shared__ float4 s_cap[kTile];
  __shared__ float4 s_used[kTile];
  __shared__ float s_lam[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (c.a + kRowsPerBlock - 1) / kRowsPerBlock;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    int row[kRowsPerWarp];
    bool live[kRowsPerWarp];
    float4 size[kRowsPerWarp];
    int cur[kRowsPerWarp];
    float cur_score[kRowsPerWarp];
    float cost[kRowsPerWarp];
    float best[kRowsPerWarp];
    int best_n[kRowsPerWarp];
    bool warp_live = false;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      row[r] = grp * kRowsPerBlock + warp * kRowsPerWarp + r;
      live[r] = row[r] < c.a && __ldcg(c.dest + row[r]) < 0;
      size[r] = live[r] ? c.sizes[row[r]] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      cur[r] = live[r] ? c.cur[row[r]] : -1;
      cur_score[r] = live[r] ? c.cur_scores[row[r]] : 0.0f;
      cost[r] = live[r] ? c.move_cost[row[r]] : 0.0f;
      best[r] = -INFINITY;
      best_n[r] = INT_MAX;
      warp_live |= live[r];
    }
    if (!__syncthreads_or(warp_live)) continue;
    for (int t0 = 0; t0 < c.n; t0 += kTile) {
      const int len = min(kTile, c.n - t0);
      __syncthreads();  // the last tile is consumed
      for (int j = threadIdx.x; j < len; j += kThreads) {
        s_cap[j] = c.capacity[t0 + j];
        s_used[j] = __ldcg(c.used + t0 + j);
        s_lam[j] = __ldcg(c.lam + t0 + j);
      }
      __syncthreads();
      if (!warp_live) continue;
      for (int j = lane; j < len; j += 32) {
        const int node = t0 + j;
        const float4 cap = s_cap[j];
        const float4 u = s_used[j];
        const float l = s_lam[j];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (!live[r]) continue;
          const size_t at = static_cast<size_t>(row[r]) * c.n + node;
          const float score = c.scores[at];
          const bool elig = c.eligible[at] != 0;
          const float g = __fsub_rn(__fsub_rn(__fsub_rn(score, cur_score[r]), cost[r]), l);
          const bool feas = fits(u, size[r], cap) & elig & (node != cur[r]) & (g > 0.0f);
          if (feas & (g > best[r])) {  // nodes rise along a lane: first index kept
            best[r] = g;
            best_n[r] = node;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      warp_argmax(best[r], best_n[r]);
      if (lane == 0 && live[r] && best_n[r] != INT_MAX) {
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(best[r])) << 32) |
            (kFull - static_cast<unsigned>(row[r]));
        atomicAdd(c.claims + best_n[r], 1);
        atomicMax(c.key + best_n[r], key);
      }
    }
  }
}

// Phase 2, block 0: admission in node order, the winners' commits, and
// usage and prices of every node.
__device__ void node_pass(const Mig& c) {
  __shared__ int s_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int moves0 = __ldcg(c.moves);
  // claimed nodes admitted this round: the first `room` in node order
  const long long room = static_cast<long long>(c.budget) - moves0;
  int carried = 0;  // claimed nodes below this chunk
  for (int base = 0; base < c.n; base += kThreads) {
    const int node = base + static_cast<int>(threadIdx.x);
    const int count = node < c.n ? __ldcg(c.claims + node) : 0;
    const bool has = count > 0;
    const unsigned ballot = __ballot_sync(kFull, has);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int below = 0;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_count[w];
      below += w < warp ? v : 0;
      total += v;
    }
    __syncthreads();  // s_count is rewritten by the next chunk
    if (node < c.n) {
      const int rank = carried + below + __popc(ballot & ((1u << lane) - 1u));
      float4 add = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (has && rank < room) {
        const unsigned long long key = __ldcg(c.key + node);
        const int a = static_cast<int>(kFull - static_cast<unsigned>(key));
        add = c.sizes[a];
        __stcg(c.dest + a, node);
        __stcg(c.gains + a, __uint_as_float(static_cast<unsigned>(key >> 32)));
      }
      float4 u = __ldcg(c.used + node);
      u.x = __fadd_rn(u.x, add.x);
      u.y = __fadd_rn(u.y, add.y);
      u.z = __fadd_rn(u.z, add.z);
      u.w = __fadd_rn(u.w, add.w);
      __stcg(c.used + node, u);
      float l = __fadd_rn(__ldcg(c.lam + node),
                          __fmul_rn(kEta, __int2float_rn(max(count - 1, 0))));
      if (count == 0) {
        l = __fsub_rn(l, kEta);
        l = l < 0.0f ? 0.0f : l;  // np.maximum(l, 0): NaN and -0.0 stay
      }
      __stcg(c.lam + node, l);
      if (has) {
        __stcg(c.claims + node, 0);
        __stcg(c.key + node, 0ull);
      }
    }
    carried += total;
  }
  if (threadIdx.x == 0) {
    const long long won = carried < room ? carried : (room > 0 ? room : 0);
    const int moves = moves0 + static_cast<int>(won);
    __stcg(c.moves, moves);
    if (carried > 0) __stcg(c.rounds, __ldcg(c.rounds) + 1);
    __stcg(c.progress, carried > 0 && moves < c.budget ? 1 : 0);
  }
}

__global__ void __launch_bounds__(kThreads) migrate_kernel(Mig c) {
  for (int it = 0; it < c.steps; ++it) {
    row_pass(c);
    grid_barrier(c.barrier);
    if (blockIdx.x == 0) node_pass(c);
    grid_barrier(c.barrier);
    if (!__ldcg(c.progress)) break;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// C entry points, bound with ctypes (nomad_tpu_torch/device/migrate.py).

// Words of the zero-filled int32 scratch `nomad_migrate_plan` takes for N
// nodes; a negative cudaError on failure.
extern "C" long long nomad_migrate_scratch_words(int n) {
  if (n < 1) return -static_cast<long long>(cudaErrorInvalidValue);
  return kHeader + 3LL * n;
}

// One cooperative launch on `stream`; allocates nothing and returns the
// launch's error (0 when it was accepted). `d` must be 4 (capacity, used
// and sizes are read as one float4 a row, 16-byte aligned). `used`,
// `lam`, `dest`, `gains`, `moves` and `rounds` hold their initial values
// on entry; `scratch` holds nomad_migrate_scratch_words(n) zeroed words.
extern "C" int nomad_migrate_plan(
    const float* capacity, const float* sizes, const int32_t* cur,
    const uint8_t* eligible, const float* scores, const float* cur_scores,
    const float* move_cost, int a, int n, int d, int budget, int steps,
    int32_t* scratch, float* used, float* lam, int32_t* dest, float* gains,
    int32_t* moves, int32_t* rounds, void* stream) {
  if (a < 1 || n < 1 || d != 4 || steps < 1 || !aligned16(capacity) ||
      !aligned16(sizes) || !aligned16(used) || !aligned16(scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, migrate_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int groups = (a + kRowsPerBlock - 1) / kRowsPerBlock;
  const int grid = groups < sms * per_sm ? groups : sms * per_sm;
  Mig c{};
  c.capacity = reinterpret_cast<const float4*>(capacity);
  c.sizes = reinterpret_cast<const float4*>(sizes);
  c.cur = cur;
  c.eligible = eligible;
  c.scores = scores;
  c.cur_scores = cur_scores;
  c.move_cost = move_cost;
  c.a = a;
  c.n = n;
  c.budget = budget;
  c.steps = steps;
  c.barrier = reinterpret_cast<unsigned*>(scratch);
  c.progress = scratch + 2;
  c.key = reinterpret_cast<unsigned long long*>(scratch + kHeader);
  c.claims = scratch + kHeader + 2LL * n;
  c.used = reinterpret_cast<float4*>(used);
  c.lam = lam;
  c.dest = dest;
  c.gains = gains;
  c.moves = moves;
  c.rounds = rounds;
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(migrate_kernel),
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
