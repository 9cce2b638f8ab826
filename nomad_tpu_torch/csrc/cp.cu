// Joint placement auction (iterated proportional rounding) on Hopper
// (sm_90a).
//
// Replaces nomad_tpu/device/cp.py:cp_place_kernel and
// cp_gang_place_kernel (one body, templated on the gang topology term).
//
// One round, as the reference's while_loop body:
//  - every group short of its count prices each node, u = (score - lam)
//    - ANTI * (same-job instances of other groups on it), plus for gang
//    groups the signed topology term f32(sum over rack/pod/ici of
//    q * gang-mate instances on nodes of the same coordinate) / 256, on
//    the nodes where one more instance fits, the group is eligible and
//    distinct_hosts holds (-inf elsewhere), and claims its argmax (first
//    index, 0 when every node is -inf);
//  - each claimed node admits one claimant: highest priority, then
//    highest u, then lowest group; the winner's node usage grows by its
//    ask, its slot min(placed, C - 1) takes the node and score[g, node];
//  - on every node, usage += (claimed ? winner's ask : 0) and lam += ETA *
//    max(claims - 1, 0), then lam = max(lam - ETA, 0) where nobody
//    claimed; gang groups count a round they could claim and lost
//    (waits).
// The loop ends after the first round without a claimant (whose lam decay
// stands) or after `steps` rounds.
//
// What bounds it on the H100: the chain of rounds. A round reads each
// active group's score, eligibility, existing-alloc and assignment rows
// (13 bytes a node) and the node state (36 bytes a node), a few MB at
// G 100 and N 16,384, and its operations are a few dozen a cell; but each
// round depends on the last, so the pass costs rounds x (one row pass +
// the resolution + the node update + three grid-wide barriers).
//
// Design: one cooperative launch of one 1,024-thread block per SM that
// loops over the rounds, with a grid-wide barrier (an arrival counter and
// a generation word, spun on with atomics) between the phases:
//  1. row pass: (group, node segment) items over the blocks, each a
//     block-wide (value desc, index asc) argmax and an any-feasible flag;
//  2. block 0: per group the segments' argmax (the claim and its utility
//     u; a warp a group when a row has several segments), then the
//     resolution by an O(G^2) scan of the claimants staged in shared
//     memory, then the commits of the winners (slots, the
//     assignment row, the per-(job, node) sibling table, the
//     per-(gang, coordinate) topology tables by integer atomicAdd);
//  3. node pass: usage and lam on every node.
// The reference's integer matrix products become those count tables:
// sib_all[g, n] = S[job(g), n], mates(level)[g, n] = T[gang(g), id(n)];
// every sum is an exact integer sum. State crossing blocks is read and
// written at L2 (__ldcg / __stcg): the SMs' L1 caches are not coherent.
//
// Numerics: separately rounded f32 ops in the reference's order and the
// build's -fmad=false; the priced terms are exact (powers of two times
// small integers). Scores are finite, as every caller gives them.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEta = 0.125f;
constexpr float kAnti = 0.0625f;
constexpr float kTopoScale = 0.00390625f;  // 1 / 256
constexpr long long kHeader = 32;          // barrier (2 words), progress
constexpr int kTile = 1024;                // claims staged per resolution tile

struct Cp {
  const float* capacity;     // [N, 4]
  const float* asks;         // [G, 4]
  const int32_t* counts;     // [G]
  const uint8_t* eligible;   // [G, N]
  const float* scores;       // [G, N]
  const float* prio;         // [G]
  const int32_t* job_counts; // [G, N]
  const uint8_t* distinct;   // [G]
  const int32_t* job_code;   // [G] dense 0..jobs-1
  const int32_t* gang_code;  // [G] dense, -1 = not in a gang (gang only)
  const int32_t* q_rack;     // [G] weights on the 1/256 grid (gang only)
  const int32_t* q_pod;
  const int32_t* q_ici;
  const int32_t* rack_id;    // [N] 0 = no coordinate (gang only)
  const int32_t* pod_id;
  const int32_t* ici_id;
  int wr, wp, wi;            // coordinate table widths
  int g, n, steps, max_c, segs, seg_len;
  unsigned* barrier;         // [2]: arrivals, generation
  int32_t* progress;         // [1]
  int32_t* placed;           // [G]
  int32_t* assigned;         // [G, N]
  int32_t* sib;              // [jobs, N]
  int32_t* t_rack;           // [gangs, wr]
  int32_t* t_pod;            // [gangs, wp]
  int32_t* t_ici;            // [gangs, wi]
  float* seg_val;            // [G, segs]
  int32_t* seg_row;
  int32_t* seg_any;
  int32_t* claim;            // [G]
  float* uclaim;
  int32_t* claimable;
  int32_t* win;              // [N]
  int32_t* claims;
  int32_t* has;
  float* used;               // [N, 4], used0 on entry
  float* lam;                // [N], lam0 on entry
  int32_t* choices;          // [G, C], -1 on entry
  float* choice_scores;      // [G, C], 0 on entry
  int32_t* rounds;           // [1], 0 on entry
  int32_t* waits;            // [G], 0 on entry
};

struct Layout {
  long long placed, assigned, sib, t_rack, t_pod, t_ici, seg_val, seg_row,
      seg_any, claim, uclaim, claimable, win, claims, has, total;
};

Layout layout(int g, int n, int jobs, int gangs, int wr, int wp, int wi,
              bool gang, int segs) {
  Layout l{};
  long long at = kHeader;
  auto take = [&at](long long words) {
    const long long start = at;
    at += (words + 31) / 32 * 32;
    return start;
  };
  const long long gn = static_cast<long long>(g) * n;
  l.placed = take(g);
  l.assigned = take(gn);
  l.sib = take(static_cast<long long>(jobs) * n);
  l.t_rack = take(gang ? static_cast<long long>(gangs) * wr : 0);
  l.t_pod = take(gang ? static_cast<long long>(gangs) * wp : 0);
  l.t_ici = take(gang ? static_cast<long long>(gangs) * wi : 0);
  l.seg_val = take(static_cast<long long>(g) * segs);
  l.seg_row = take(static_cast<long long>(g) * segs);
  l.seg_any = take(static_cast<long long>(g) * segs);
  l.claim = take(g);
  l.uclaim = take(g);
  l.claimable = take(g);
  l.win = take(n);
  l.claims = take(n);
  l.has = take(n);
  l.total = at;
  return l;
}

// One block per SM; the row pass splits each group's row into `segs`
// segments so that G * segs items fill the grid.
cudaError_t plan(int g, int n, int* grid, int* segs, int* seg_len) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(grid, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int s0 = *grid / g > 1 ? *grid / g : 1;
  *seg_len = (n + s0 - 1) / s0;
  *segs = (n + *seg_len - 1) / *seg_len;
  return cudaSuccess;
}

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

template <bool kGang>
__device__ __forceinline__ float priced(const Cp& c, int g, int n, int sib_other) {
  const size_t gn = static_cast<size_t>(g) * c.n + n;
  float u = __fsub_rn(__fsub_rn(c.scores[gn], __ldcg(c.lam + n)),
                      __fmul_rn(kAnti, __int2float_rn(sib_other)));
  if (kGang) {
    int acc = 0;
    const int gc = c.gang_code[g];
    if (gc >= 0) {
      const int r = c.rack_id[n];
      const int p = c.pod_id[n];
      const int i = c.ici_id[n];
      const int mr = r > 0 ? __ldcg(c.t_rack + static_cast<size_t>(gc) * c.wr + r) : 0;
      const int mp = p > 0 ? __ldcg(c.t_pod + static_cast<size_t>(gc) * c.wp + p) : 0;
      const int mi = i > 0 ? __ldcg(c.t_ici + static_cast<size_t>(gc) * c.wi + i) : 0;
      acc = c.q_rack[g] * mr + c.q_pod[g] * mp + c.q_ici[g] * mi;
    }
    u = __fadd_rn(u, __fmul_rn(__int2float_rn(acc), kTopoScale));
  }
  return u;
}

// Phase 1: the (value, index) argmax of one group's priced row over one
// segment, and whether any node of it is feasible.
template <bool kGang>
__device__ void row_pass(const Cp& c) {
  __shared__ float s_k[kWarps];
  __shared__ int s_r[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int item = blockIdx.x; item < c.g * c.segs; item += gridDim.x) {
    const int g = item / c.segs;
    const int s = item - g * c.segs;
    float bk = -INFINITY;
    int br = INT_MAX;
    int any = 0;
    if (__ldcg(c.placed + g) < c.counts[g]) {
      const int lo = s * c.seg_len;
      const int hi = min(c.n, lo + c.seg_len);
      const float* a = c.asks + 4 * static_cast<size_t>(g);
      const int32_t* sib = c.sib + static_cast<size_t>(c.job_code[g]) * c.n;
      const bool distinct = c.distinct[g] != 0;
#pragma unroll 4
      for (int n = lo + static_cast<int>(threadIdx.x); n < hi; n += kThreads) {
        bool fit = true;
        for (int d = 0; d < 4; ++d) {
          fit &= __fadd_rn(__ldcg(c.used + 4 * static_cast<size_t>(n) + d), a[d]) <=
                 c.capacity[4 * static_cast<size_t>(n) + d];
        }
        const size_t gn = static_cast<size_t>(g) * c.n + n;
        const int sib_all = __ldcg(sib + n);
        const bool taken = c.job_counts[gn] + sib_all > 0;
        const bool feas = fit && c.eligible[gn] != 0 && !(distinct && taken);
        const float u = feas ? priced<kGang>(c, g, n, sib_all - __ldcg(c.assigned + gn))
                             : -INFINITY;
        any |= feas;
        if (before(u, n, bk, br)) {
          bk = u;
          br = n;
        }
      }
    }
    warp_argmax(bk, br);
    if (lane == 0) {
      s_k[warp] = bk;
      s_r[warp] = br;
    }
    any = __syncthreads_or(any);
    if (warp == 0) {
      bk = lane < kWarps ? s_k[lane] : -INFINITY;
      br = lane < kWarps ? s_r[lane] : INT_MAX;
      warp_argmax(bk, br);
      if (lane == 0) {
        __stcg(c.seg_val + item, bk);
        __stcg(c.seg_row + item, br);
        __stcg(c.seg_any + item, any);
      }
    }
    __syncthreads();
  }
}

// The claim of group g from its segments' argmaxes, in segment order.
__device__ __forceinline__ void store_claim(const Cp& c, int g, float bk, int br, int any) {
  const int active = __ldcg(c.placed + g) < c.counts[g];
  __stcg(c.claim + g, br == INT_MAX ? 0 : br);
  __stcg(c.uclaim + g, bk);
  __stcg(c.claimable + g, active && any ? 1 : 0);
}

// Phase 2, block 0: claims, the resolution and the winners' commits.
template <bool kGang>
__device__ void resolve(const Cp& c) {
  __shared__ int s_claim[kTile];  // -1 where the group cannot claim
  __shared__ float s_prio[kTile];
  __shared__ float s_u[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (c.segs == 1) {
    for (int g = threadIdx.x; g < c.g; g += kThreads) {
      store_claim(c, g, __ldcg(c.seg_val + g), __ldcg(c.seg_row + g),
                  __ldcg(c.seg_any + g));
    }
  } else {
    // a warp a group: the lanes read its segments, then a warp argmax
    for (int g = warp; g < c.g; g += kWarps) {
      float bk = -INFINITY;
      int br = INT_MAX;
      int any = 0;
      for (int s = lane; s < c.segs; s += 32) {
        const int item = g * c.segs + s;
        const float v = __ldcg(c.seg_val + item);
        const int r = __ldcg(c.seg_row + item);
        if (before(v, r, bk, br)) {
          bk = v;
          br = r;
        }
        any |= __ldcg(c.seg_any + item);
      }
      warp_argmax(bk, br);
      any = __any_sync(kFull, any);
      if (lane == 0) store_claim(c, g, bk, br, any);
    }
  }
  __syncthreads();
  // each claimed node admits the claimant first in (priority desc, u
  // desc, group asc); the reference's masked argmax gives group 0 when
  // that claimant's u is -inf. The claims are staged through shared
  // memory a tile at a time.
  for (int g0 = 0; g0 < c.g; g0 += kThreads) {
    const int g = g0 + static_cast<int>(threadIdx.x);
    const bool mine = g < c.g && __ldcg(c.claimable + g) != 0;
    const int node = mine ? __ldcg(c.claim + g) : -1;
    const float pg = mine ? c.prio[g] : 0.0f;
    const float ug = mine ? __ldcg(c.uclaim + g) : 0.0f;
    int count = 0;
    bool beaten = false;
    for (int t0 = 0; t0 < c.g; t0 += kTile) {
      const int tile = min(kTile, c.g - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < tile; i += kThreads) {
        const int o = t0 + i;
        s_claim[i] = __ldcg(c.claimable + o) ? __ldcg(c.claim + o) : -1;
        s_prio[i] = c.prio[o];
        s_u[i] = __ldcg(c.uclaim + o);
      }
      __syncthreads();
      if (mine) {
        for (int i = 0; i < tile; ++i) {
          if (s_claim[i] != node) continue;
          ++count;
          const int o = t0 + i;
          const float po = s_prio[i];
          const float uo = s_u[i];
          beaten |= po > pg || (po == pg && (uo > ug || (uo == ug && o < g)));
        }
      }
    }
    if (mine && !beaten) {
      __stcg(c.win + node, ug > -INFINITY ? g : 0);
      __stcg(c.has + node, 1);
      __stcg(c.claims + node, count);
    }
  }
  __syncthreads();
  int progress = 0;
  for (int g = threadIdx.x; g < c.g; g += kThreads) {
    if (!__ldcg(c.claimable + g)) continue;
    progress = 1;
    const int node = __ldcg(c.claim + g);
    if (__ldcg(c.win + node) != g) {
      if (kGang) c.waits[g] += 1;
      continue;
    }
    const int placed = __ldcg(c.placed + g);
    const int slot = min(placed, c.max_c - 1);
    const size_t gc_slot = static_cast<size_t>(g) * c.max_c + slot;
    c.choices[gc_slot] = node;
    c.choice_scores[gc_slot] = c.scores[static_cast<size_t>(g) * c.n + node];
    int32_t* a = c.assigned + static_cast<size_t>(g) * c.n + node;
    __stcg(a, __ldcg(a) + 1);
    // one winner per node: no other commit of this round touches this word
    int32_t* s = c.sib + static_cast<size_t>(c.job_code[g]) * c.n + node;
    __stcg(s, __ldcg(s) + 1);
    __stcg(c.placed + g, placed + 1);
    if (kGang) {
      const int gc = c.gang_code[g];
      if (gc >= 0) {
        const int r = c.rack_id[node];
        const int p = c.pod_id[node];
        const int i = c.ici_id[node];
        if (r > 0) atomicAdd(c.t_rack + static_cast<size_t>(gc) * c.wr + r, 1);
        if (p > 0) atomicAdd(c.t_pod + static_cast<size_t>(gc) * c.wp + p, 1);
        if (i > 0) atomicAdd(c.t_ici + static_cast<size_t>(gc) * c.wi + i, 1);
      }
    }
  }
  progress = __syncthreads_or(progress);
  if (threadIdx.x == 0) {
    __stcg(c.progress, progress);
    if (progress) c.rounds[0] += 1;
  }
}

// Phase 3: usage and prices of every node.
__device__ void node_pass(const Cp& c) {
  const int stride = gridDim.x * kThreads;
  for (int n = blockIdx.x * kThreads + threadIdx.x; n < c.n; n += stride) {
    const int has = __ldcg(c.has + n);
    const int count = __ldcg(c.claims + n);
    const float* a = c.asks + 4 * static_cast<size_t>(has ? __ldcg(c.win + n) : 0);
    for (int d = 0; d < 4; ++d) {
      float* u = c.used + 4 * static_cast<size_t>(n) + d;
      __stcg(u, __fadd_rn(__ldcg(u), has ? a[d] : 0.0f));
    }
    float l = __fadd_rn(__ldcg(c.lam + n),
                        __fmul_rn(kEta, __int2float_rn(max(count - 1, 0))));
    if (count == 0) l = fmaxf(__fsub_rn(l, kEta), 0.0f);
    __stcg(c.lam + n, l);
    if (has) {
      __stcg(c.has + n, 0);
      __stcg(c.claims + n, 0);
    }
  }
}

template <bool kGang>
__global__ void __launch_bounds__(kThreads) cp_kernel(Cp c) {
  for (int it = 0; it < c.steps; ++it) {
    row_pass<kGang>(c);
    grid_barrier(c.barrier);
    if (blockIdx.x == 0) resolve<kGang>(c);
    grid_barrier(c.barrier);
    node_pass(c);
    grid_barrier(c.barrier);
    if (!__ldcg(c.progress)) break;
  }
}

}  // namespace

// C entry points, bound with ctypes (nomad_tpu_torch/device/cp.py).

// Words of the zero-filled int32 scratch `nomad_cp_place` takes for these
// sizes on the current device; a negative cudaError on failure.
extern "C" long long nomad_cp_scratch_words(int g, int n, int jobs, int gangs,
                                             int wr, int wp, int wi, int gang) {
  if (g < 1 || n < 1 || jobs < 1) return -static_cast<long long>(cudaErrorInvalidValue);
  int grid = 0, segs = 0, seg_len = 0;
  const cudaError_t e = plan(g, n, &grid, &segs, &seg_len);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return layout(g, n, jobs, gangs, wr, wp, wi, gang != 0, segs).total;
}

// One cooperative launch on `stream`; allocates nothing and returns the
// launch's error (0 when it was accepted). The gang term is on when
// `gang_code` is not null (then q_*, the three rows of `level_ids` [3, N]
// and the widths describe it). `used`, `lam`, `choices`, `choice_scores`,
// `rounds` and `waits` hold their initial values on entry.
extern "C" int nomad_cp_place(
    const float* capacity, const float* asks, const int32_t* counts,
    const uint8_t* eligible, const float* scores, const float* prio,
    const int32_t* job_counts, const uint8_t* distinct,
    const int32_t* job_code, int jobs, const int32_t* gang_code,
    const int32_t* q_rack, const int32_t* q_pod, const int32_t* q_ici,
    const int32_t* level_ids, int gangs, int wr, int wp, int wi, int g,
    int n, int steps, int max_c, int32_t* scratch, float* used, float* lam,
    int32_t* choices, float* choice_scores, int32_t* rounds, int32_t* waits,
    void* stream) {
  const bool gang = gang_code != nullptr;
  if (g < 1 || n < 1 || jobs < 1 || max_c < 1 ||
      (gang && (wr < 1 || wp < 1 || wi < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0, segs = 0, seg_len = 0;
  cudaError_t e = plan(g, n, &grid, &segs, &seg_len);
  if (e != cudaSuccess) return static_cast<int>(e);
  void (*kernel)(Cp) = gang ? cp_kernel<true> : cp_kernel<false>;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const Layout l = layout(g, n, jobs, gangs, wr, wp, wi, gang, segs);
  Cp c{};
  c.capacity = capacity;
  c.asks = asks;
  c.counts = counts;
  c.eligible = eligible;
  c.scores = scores;
  c.prio = prio;
  c.job_counts = job_counts;
  c.distinct = distinct;
  c.job_code = job_code;
  c.gang_code = gang_code;
  c.q_rack = q_rack;
  c.q_pod = q_pod;
  c.q_ici = q_ici;
  c.rack_id = gang ? level_ids : nullptr;
  c.pod_id = gang ? level_ids + n : nullptr;
  c.ici_id = gang ? level_ids + 2 * static_cast<size_t>(n) : nullptr;
  c.wr = wr;
  c.wp = wp;
  c.wi = wi;
  c.g = g;
  c.n = n;
  c.steps = steps;
  c.max_c = max_c;
  c.segs = segs;
  c.seg_len = seg_len;
  c.barrier = reinterpret_cast<unsigned*>(scratch);
  c.progress = scratch + 2;
  c.placed = scratch + l.placed;
  c.assigned = scratch + l.assigned;
  c.sib = scratch + l.sib;
  c.t_rack = scratch + l.t_rack;
  c.t_pod = scratch + l.t_pod;
  c.t_ici = scratch + l.t_ici;
  c.seg_val = reinterpret_cast<float*>(scratch + l.seg_val);
  c.seg_row = scratch + l.seg_row;
  c.seg_any = scratch + l.seg_any;
  c.claim = scratch + l.claim;
  c.uclaim = reinterpret_cast<float*>(scratch + l.uclaim);
  c.claimable = scratch + l.claimable;
  c.win = scratch + l.win;
  c.claims = scratch + l.claims;
  c.has = scratch + l.has;
  c.used = used;
  c.lam = lam;
  c.choices = choices;
  c.choice_scores = choice_scores;
  c.rounds = rounds;
  c.waits = waits;
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                  dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
