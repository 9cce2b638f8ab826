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
// the resolution + two grid-wide barriers).
//
// Design: one cooperative launch of one 1,024-thread block per SM that
// loops over the rounds, with a grid-wide barrier (an arrival counter and
// a generation word, spun on with atomics) after each of two phases:
//  1. row pass: (group, node segment) items over the blocks, each a
//     block-wide (value desc, index asc) argmax and an any-feasible flag,
//     merged into the group's claim word by a 64-bit max of
//     (order_key(u) << 32 | ~node) and an integer or: exact in any order;
//  2. settle, on every block over its slice of the nodes: each block reads
//     every group's claim word and resolves the claims on its own nodes in
//     shared memory, a 64-bit max of (order_key(priority) << 32 |
//     order_key(u)), then the least group among the claimants that reach
//     it (the reference's masked argmax gives group 0 when the winner's u
//     is -inf); the winner commits (its slot, the assignment row, the
//     per-(job, node) sibling table, the per-(gang, coordinate) topology
//     tables by integer atomicAdd), and usage and lam update on every node
//     of the slice. Whether any group claimed is read from the claim words
//     by every block alike, so all leave the loop together.
// The claim words of a round are double-buffered, the other buffer
// cleared in phase 2 for the next round.
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

#include <vector>

#include "mesh_loop.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEta = 0.125f;
constexpr float kAnti = 0.0625f;
constexpr float kTopoScale = 0.00390625f;  // 1 / 256
constexpr long long kHeader = 32;          // barrier (2 words)
constexpr int kSlice = 1024;               // nodes of a slice settled at a time

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
  bool vec;                  // used and capacity 16-byte aligned
  unsigned* barrier;         // [2]: arrivals, generation
  int32_t* placed;           // [G]
  int32_t* assigned;         // [G, N]
  int32_t* sib;              // [jobs, N]
  int32_t* t_rack;           // [gangs, wr]
  int32_t* t_pod;            // [gangs, wp]
  int32_t* t_ici;            // [gangs, wi]
  unsigned long long* claim; // [2, G]: (order_key(u) << 32 | ~node), 0 = none
  int32_t* any;              // [2, G]: active and some node feasible
  float* used;               // [N, 4], used0 on entry
  float* lam;                // [N], lam0 on entry
  int32_t* choices;          // [G, C], -1 on entry
  float* choice_scores;      // [G, C], 0 on entry
  int32_t* rounds;           // [1], 0 on entry
  int32_t* waits;            // [G], 0 on entry
};

struct Layout {
  long long placed, assigned, sib, t_rack, t_pod, t_ici, claim, any, total;
};

Layout layout(int g, int n, int jobs, int gangs, int wr, int wp, int wi,
              bool gang) {
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
  l.claim = take(4LL * g);
  l.any = take(2LL * g);
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

// Total order on floats as u32: a larger float gives a larger key. -0
// folds onto +0, which compare equal as floats.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
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

// The gang term of group g on node n: f32(sum over rack/pod/ici of q *
// gang-mate instances on nodes of n's coordinate) / 256.
__device__ __forceinline__ float topo_term(const Cp& c, int g, int n) {
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
  return __fmul_rn(__int2float_rn(acc), kTopoScale);
}

// A node's 4 dims, one 16-byte load where aligned.
template <bool kL2>
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return kL2 ? __ldcg(q) : __ldg(q);
  }
  return kL2 ? make_float4(__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3))
             : make_float4(p[0], p[1], p[2], p[3]);
}

// Phase 1: the (value, index) argmax of one group's priced row over one
// segment, and whether any node of it is feasible.
template <bool kGang>
__device__ void row_pass(const Cp& c, int par) {
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
    const bool active = __ldcg(c.placed + g) < c.counts[g];
    if (active) {
      const int lo = s * c.seg_len;
      const int hi = min(c.n, lo + c.seg_len);
      const float* a = c.asks + 4 * static_cast<size_t>(g);
      const int32_t* sib = c.sib + static_cast<size_t>(c.job_code[g]) * c.n;
      const bool distinct = c.distinct[g] != 0;
      const float4 ask = make_float4(a[0], a[1], a[2], a[3]);
#pragma unroll 4
      for (int n = lo + static_cast<int>(threadIdx.x); n < hi; n += kThreads) {
        // every load of the node issued at once, whatever it feeds
        const float4 used = load4<true>(c.used + 4 * static_cast<size_t>(n), c.vec);
        const float4 cap = load4<false>(c.capacity + 4 * static_cast<size_t>(n), c.vec);
        const size_t gn = static_cast<size_t>(g) * c.n + n;
        const int sib_all = __ldcg(sib + n);
        const int job = c.job_counts[gn];
        const bool elig = c.eligible[gn] != 0;
        const float score = c.scores[gn];
        const float lam = __ldcg(c.lam + n);
        const int mine = __ldcg(c.assigned + gn);
        const bool fit = (__fadd_rn(used.x, ask.x) <= cap.x) & (__fadd_rn(used.y, ask.y) <= cap.y) &
                         (__fadd_rn(used.z, ask.z) <= cap.z) & (__fadd_rn(used.w, ask.w) <= cap.w);
        const bool taken = job + sib_all > 0;
        const bool feas = fit && elig && !(distinct && taken);
        // u = (score - lam) - ANTI * (same-job instances of other groups)
        float u = __fsub_rn(__fsub_rn(score, lam),
                            __fmul_rn(kAnti, __int2float_rn(sib_all - mine)));
        if (kGang && feas) u = __fadd_rn(u, topo_term(c, g, n));
        u = feas ? u : -INFINITY;
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
    if (warp == 0 && active) {
      bk = lane < kWarps ? s_k[lane] : -INFINITY;
      br = lane < kWarps ? s_r[lane] : INT_MAX;
      warp_argmax(bk, br);
      if (lane == 0 && br != INT_MAX) {
        // a NaN u never wins, as in the argmax above
        const uint32_t uk = bk == bk ? order_key(bk) : 0u;
        atomicMax(c.claim + par * c.g + g,
                  (static_cast<unsigned long long>(uk) << 32) |
                      (kFull - static_cast<unsigned>(br)));
        if (any) atomicOr(c.any + par * c.g + g, 1);
      }
    }
    __syncthreads();
  }
}

struct SettleShared {
  int zero_node;                   // group 0's claim when it can claim, else -1
  int count[kSlice];
  unsigned long long top[kSlice];  // (order_key(prio) << 32 | order_key(u))
  int least[kSlice];               // the least group reaching `top`
  int win[kSlice];
};

__device__ __forceinline__ int claim_node(unsigned long long w) {
  return static_cast<int>(kFull - static_cast<unsigned>(w));
}

// Phase 2, every block on its slice of the nodes: the claims on them
// resolved, the winners' commits, usage and prices. Returns whether any
// group claimed this round (the same on every block).
template <bool kGang>
__device__ bool settle(const Cp& c, SettleShared& s, int par) {
  const unsigned long long* claim = c.claim + par * c.g;
  const int32_t* any = c.any + par * c.g;
  // a group's rank word (order_key(prio) << 32 | order_key(u)) and node
  // when it can claim; the thread's first group is read once, in registers
  const auto read = [&](int g, unsigned long long* rank, int* node) {
    if (!__ldcg(any + g)) return false;
    const unsigned long long w = __ldcg(claim + g);
    *rank = (static_cast<unsigned long long>(order_key(c.prio[g])) << 32) | (w >> 32);
    *node = claim_node(w);
    return true;
  };
  unsigned long long rank0 = 0;
  int node0 = -1;
  const bool has0 = static_cast<int>(threadIdx.x) < c.g && read(threadIdx.x, &rank0, &node0);
  const auto group = [&](int g, unsigned long long* rank, int* node) {
    if (g == static_cast<int>(threadIdx.x)) {
      *rank = rank0;
      *node = node0;
      return has0;
    }
    return read(g, rank, node);
  };
  int progress = has0;
  for (int g = threadIdx.x + kThreads; g < c.g; g += kThreads) progress |= __ldcg(any + g);
  if (threadIdx.x == 0) s.zero_node = has0 ? node0 : -1;
  progress = __syncthreads_or(progress);
  const int slice = (c.n + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  const int lo0 = blockIdx.x * slice;
  const int hi0 = min(c.n, lo0 + slice);
  for (int lo = lo0; lo < hi0; lo += kSlice) {
    const int len = min(kSlice, hi0 - lo);
    for (int j = threadIdx.x; j < len; j += kThreads) {
      s.count[j] = 0;
      s.top[j] = 0ull;
      s.least[j] = INT_MAX;
    }
    __syncthreads();
    // the claimants of this chunk: how many, and the highest (priority, u)
    for (int g = threadIdx.x; g < c.g; g += kThreads) {
      unsigned long long rank;
      int node;
      if (!group(g, &rank, &node) || node < lo || node >= lo + len) continue;
      atomicAdd(&s.count[node - lo], 1);
      atomicMax(&s.top[node - lo], rank);
    }
    __syncthreads();
    // then the least group among those that reach it
    for (int g = threadIdx.x; g < c.g; g += kThreads) {
      unsigned long long rank;
      int node;
      if (!group(g, &rank, &node) || node < lo || node >= lo + len) continue;
      if (rank == s.top[node - lo]) atomicMin(&s.least[node - lo], g);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const int n = lo + j;
      const int count = s.count[j];
      int ask_row = 0;  // whose ask the node's usage grows by
      int won = -1;     // the group that commits here, if any
      if (count > 0) {
        const float u = key_value(static_cast<uint32_t>(s.top[j]));
        ask_row = u > -INFINITY ? s.least[j] : 0;
        // the least claimant commits; group 0 after a -inf winner only if
        // it claimed here
        won = u > -INFINITY ? ask_row : (s.zero_node == n ? 0 : -1);
      }
      s.win[j] = won;
      if (won >= 0) {
        const int placed = __ldcg(c.placed + won);
        const int slot = min(placed, c.max_c - 1);
        const size_t gc_slot = static_cast<size_t>(won) * c.max_c + slot;
        __stcg(c.choices + gc_slot, n);
        __stcg(c.choice_scores + gc_slot, c.scores[static_cast<size_t>(won) * c.n + n]);
        int32_t* a = c.assigned + static_cast<size_t>(won) * c.n + n;
        __stcg(a, __ldcg(a) + 1);
        // one winner per node: no other commit of this round touches this word
        int32_t* sb = c.sib + static_cast<size_t>(c.job_code[won]) * c.n + n;
        __stcg(sb, __ldcg(sb) + 1);
        __stcg(c.placed + won, placed + 1);
        if (kGang) {
          const int gc = c.gang_code[won];
          if (gc >= 0) {
            const int r = c.rack_id[n];
            const int p = c.pod_id[n];
            const int i = c.ici_id[n];
            if (r > 0) atomicAdd(c.t_rack + static_cast<size_t>(gc) * c.wr + r, 1);
            if (p > 0) atomicAdd(c.t_pod + static_cast<size_t>(gc) * c.wp + p, 1);
            if (i > 0) atomicAdd(c.t_ici + static_cast<size_t>(gc) * c.wi + i, 1);
          }
        }
      }
      // usage and price of every node, as the reference's node update
      const float* a = c.asks + 4 * static_cast<size_t>(ask_row);
      for (int d = 0; d < 4; ++d) {
        float* u = c.used + 4 * static_cast<size_t>(n) + d;
        __stcg(u, __fadd_rn(__ldcg(u), count > 0 ? a[d] : 0.0f));
      }
      float l = __fadd_rn(__ldcg(c.lam + n),
                          __fmul_rn(kEta, __int2float_rn(max(count - 1, 0))));
      if (count == 0) l = fmaxf(__fsub_rn(l, kEta), 0.0f);
      __stcg(c.lam + n, l);
    }
    __syncthreads();
    if (kGang) {
      // a group that could claim and lost its node waits a round
      for (int g = threadIdx.x; g < c.g; g += kThreads) {
        unsigned long long rank;
        int node;
        if (!group(g, &rank, &node) || node < lo || node >= lo + len) continue;
        if (s.win[node - lo] != g) __stcg(c.waits + g, __ldcg(c.waits + g) + 1);
      }
    }
    __syncthreads();  // the chunk's shared state is reused by the next
  }
  if (progress && blockIdx.x == 0 && threadIdx.x == 0) c.rounds[0] += 1;
  // the other buffer's claim words start the next round empty
  const int stride = gridDim.x * kThreads;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < c.g; g += stride) {
    __stcg(c.claim + (par ^ 1) * c.g + g, 0ull);
    __stcg(c.any + (par ^ 1) * c.g + g, 0);
  }
  return progress != 0;
}

template <bool kGang>
__global__ void __launch_bounds__(kThreads) cp_kernel(Cp c) {
  __shared__ SettleShared s;
  for (int it = 0; it < c.steps; ++it) {
    const int par = it & 1;
    row_pass<kGang>(c, par);
    grid_barrier(c.barrier);
    if (!settle<kGang>(c, s, par)) break;
    grid_barrier(c.barrier);
  }
}

// Nothing but grid barriers: what one costs on this card, for the record.
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(unsigned* bar, int iters) {
  for (int i = 0; i < iters; ++i) grid_barrier(bar);
}

// -- the auction under a node-axis mesh ----------------------------------------
//
// Cell (i, j) of a dp x mp mesh holds groups row i's slice of the groups
// (g0 its first) and column j's slice of the nodes (col0 its first). It
// keeps the usage and prices of its nodes, its groups' assignments
// there, the per-(job, node) sibling counts of its nodes, its groups'
// placements and a copy of the per-(gang, coordinate) topology tables,
// which every cell grows by every winner (integer adds: the copies stay
// equal). A round:
//  - cp_shard_claim_kernel, a launch a cell, a block a group: the row
//    pass over the cell's nodes, as row_pass computes it, and the
//    group's word (order_key(u) << 32 | ~global node; the lowest node on
//    ties, infeasible nodes at -inf), whether a node of the cell is
//    feasible, score[g, node]'s bits and the node's coordinates;
//  - cp_round_merge_kernel, one block on the mesh lead over every group:
//    each group's claim is its best word over the columns; per claimed
//    node the claims, the highest (order_key(priority) << 32 |
//    order_key(u)) and the least group reaching it give the winner and
//    whose ask the usage grows by, the -inf rule for group 0, waits and
//    rounds, exactly as settle; it writes the winners' slots and the
//    round's record: a state, the claimed nodes M, then per claimed
//    node, sorted by node, (node, claims, winner, its job code, its gang
//    code, the node's rack / pod / ici ids, the ask's bits);
//  - cp_shard_settle_kernel, a launch a cell, a thread a node: every node
//    of the cell takes usage += (claims ? ask : 0.0) and the price update
//    (an unclaimed node adds +0.0, as the one-device kernel, which turns
//    a -0.0 into +0.0); the winners' assignments and sibling counts;
//    block 0 the winners' placements and topology counts.
// The round where no group can claim runs (its record's state is 1: its
// decay stands) and ends the pass; the merge of every later round writes
// state 2, on which every launch returns at once, and the host stops
// queuing rounds once it reads the lead's stop word (mesh_loop.cuh).

constexpr int kCand = 7;        // a candidate's ints
constexpr int kEntry = 12;      // a claimed node's ints in the record
constexpr int kRecHead = 2;     // the record's state and M
constexpr int kMergeWords = 11; // a group's ints of the merge's scratch
constexpr int kPollRounds = 16; // rounds between two reads of the lead's stop word

struct CpCell {
  const float* capacity;      // [n, 4]
  const float* asks;          // [g, 4]
  const int32_t* counts;      // [g]
  const uint8_t* eligible;    // [g, n]
  const float* scores;        // [g, n]
  const int32_t* job_counts;  // [g, n]
  const uint8_t* distinct;    // [g]
  const int32_t* job_code;    // [g]: rows of sib
  const int32_t* gang_code;   // [g], -1 = not in a gang (gang only)
  const int32_t* q_rack;      // [g] (gang only)
  const int32_t* q_pod;
  const int32_t* q_ici;
  const int32_t* level_ids;   // [3, n] (gang only)
  float* used;                // [n, 4]
  float* lam;                 // [n]
  int32_t* assigned;          // [g, n]
  int32_t* sib;               // [jobs, n]
  int32_t* t_rack;            // [gangs, wr] (gang only)
  int32_t* t_pod;             // [gangs, wp]
  int32_t* t_ici;             // [gangs, wi]
  int32_t* placed;            // [g]
  int wr, wp, wi, g, n;
};

template <bool kGang>
__global__ void __launch_bounds__(kThreads)
    cp_shard_claim_kernel(CpCell c, const int32_t* record, int col0, int32_t* cand) {
  __shared__ float s_k[kWarps];
  __shared__ int s_r[kWarps];
  if (record != nullptr && record[0] != 0) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  int32_t* out = cand + kCand * static_cast<size_t>(g);
  if (c.placed[g] >= c.counts[g]) {
    if (threadIdx.x < kCand) out[threadIdx.x] = threadIdx.x == 1 ? -1 : 0;
    return;
  }
  const float* a = c.asks + 4 * static_cast<size_t>(g);
  const float4 ask = make_float4(a[0], a[1], a[2], a[3]);
  const int32_t* sib = c.sib + static_cast<size_t>(c.job_code[g]) * c.n;
  const bool distinct = c.distinct[g] != 0;
  int gc = -1, qr = 0, qp = 0, qi = 0;
  if (kGang) {
    gc = c.gang_code[g];
    qr = c.q_rack[g];
    qp = c.q_pod[g];
    qi = c.q_ici[g];
  }
  float bk = -INFINITY;
  int br = INT_MAX;
  int any = 0;
  for (int n = threadIdx.x; n < c.n; n += kThreads) {
    const float* up = c.used + 4 * static_cast<size_t>(n);
    const float* cp = c.capacity + 4 * static_cast<size_t>(n);
    const size_t gn = static_cast<size_t>(g) * c.n + n;
    const int sib_all = sib[n];
    const bool fit = (__fadd_rn(up[0], ask.x) <= cp[0]) & (__fadd_rn(up[1], ask.y) <= cp[1]) &
                     (__fadd_rn(up[2], ask.z) <= cp[2]) & (__fadd_rn(up[3], ask.w) <= cp[3]);
    const bool taken = c.job_counts[gn] + sib_all > 0;
    const bool feas = fit && c.eligible[gn] != 0 && !(distinct && taken);
    // u = (score - lam) - ANTI * (same-job instances of other groups)
    float u = __fsub_rn(__fsub_rn(c.scores[gn], c.lam[n]),
                        __fmul_rn(kAnti, __int2float_rn(sib_all - c.assigned[gn])));
    if (kGang && feas) {
      int acc = 0;
      if (gc >= 0) {
        const int r = c.level_ids[n];
        const int p = c.level_ids[c.n + n];
        const int i = c.level_ids[2 * static_cast<size_t>(c.n) + n];
        const int mr = r > 0 ? c.t_rack[static_cast<size_t>(gc) * c.wr + r] : 0;
        const int mp = p > 0 ? c.t_pod[static_cast<size_t>(gc) * c.wp + p] : 0;
        const int mi = i > 0 ? c.t_ici[static_cast<size_t>(gc) * c.wi + i] : 0;
        acc = qr * mr + qp * mp + qi * mi;
      }
      u = __fadd_rn(u, __fmul_rn(__int2float_rn(acc), kTopoScale));
    }
    u = feas ? u : -INFINITY;
    any |= feas;
    if (before(u, n, bk, br)) {
      bk = u;
      br = n;
    }
  }
  warp_argmax(bk, br);
  if (lane == 0) {
    s_k[warp] = bk;
    s_r[warp] = br;
  }
  any = __syncthreads_or(any);
  if (warp != 0) return;
  bk = lane < kWarps ? s_k[lane] : -INFINITY;
  br = lane < kWarps ? s_r[lane] : INT_MAX;
  warp_argmax(bk, br);
  if (lane != 0) return;
  if (br == INT_MAX) br = 0;  // every u NaN: none wins, as in the row pass
  out[0] = bk == bk ? static_cast<int32_t>(order_key(bk)) : 0;
  out[1] = col0 + br;
  out[2] = any;
  out[3] = __float_as_int(c.scores[static_cast<size_t>(g) * c.n + br]);
  for (int l = 0; l < 3; ++l) {
    out[4 + l] = kGang ? c.level_ids[static_cast<size_t>(l) * c.n + br] : 0;
  }
}

// The best candidate column of group j over `cells` columns [cells, g,
// kCand] (key desc, node asc), -1 when none is held.
__device__ int best_column(const int32_t* cand, int cells, int g, int j) {
  int bc = -1;
  unsigned long long br = 0;
  for (int c = 0; c < cells; ++c) {
    const int32_t* e = cand + kCand * (static_cast<size_t>(c) * g + j);
    const uint32_t key = static_cast<uint32_t>(e[0]);
    if (key == 0u) continue;
    const unsigned long long rank =
        (static_cast<unsigned long long>(key) << 32) | (kFull - static_cast<uint32_t>(e[1]));
    if (rank > br) {
      br = rank;
      bc = c;
    }
  }
  return bc;
}

// The merge's scratch, per group: its claimed node (-1: it cannot claim),
// u's order key, the priority's order key, the score's bits, the node's
// three ids, whether it is its node's least claimant, its node's claims,
// winner and ask row.
enum MergeWord { kMNode, kMU, kMPrio, kMScore, kMIds, kMRep = kMIds + 3, kMClaims, kMWon, kMAsk };

__global__ void __launch_bounds__(kThreads)
    cp_round_merge_kernel(const int32_t* cand, int cells, int g, const float* prio,
                          const float* asks, const int32_t* job_code, const int32_t* gang_code,
                          int max_c, int32_t* placed, int32_t* waits, int32_t* rounds,
                          int32_t* choices, float* choice_scores, int32_t* record,
                          int32_t* scratch) {
  __shared__ int s_m;
  if (record[0] != 0) {  // past the end of the pass
    __syncthreads();
    if (threadIdx.x == 0) {
      record[0] = 2;
      record[1] = 0;
    }
    return;
  }
  // each group's claim over the columns
  int claimable = 0;
  for (int j = threadIdx.x; j < g; j += kThreads) {
    int32_t* w = scratch + kMergeWords * static_cast<size_t>(j);
    int any = 0;
    for (int c = 0; c < cells; ++c) any |= cand[kCand * (static_cast<size_t>(c) * g + j) + 2];
    const int bc = best_column(cand, cells, g, j);
    if (any == 0 || bc < 0) {
      w[kMNode] = -1;
      continue;
    }
    const int32_t* e = cand + kCand * (static_cast<size_t>(bc) * g + j);
    w[kMNode] = e[1];
    w[kMU] = e[0];
    w[kMPrio] = static_cast<int32_t>(order_key(prio[j]));
    w[kMScore] = e[3];
    for (int l = 0; l < 3; ++l) w[kMIds + l] = e[4 + l];
    claimable = 1;
  }
  if (threadIdx.x == 0) s_m = 0;
  const int progress = __syncthreads_or(claimable);
  const int zero_node = g > 0 ? scratch[kMNode] : -1;
  // per claimant: its node's claims, top rank and least group reaching it
  for (int j = threadIdx.x; j < g; j += kThreads) {
    int32_t* w = scratch + kMergeWords * static_cast<size_t>(j);
    const int node = w[kMNode];
    if (node < 0) continue;
    int claims = 0;
    int rep = 1;
    int least = INT_MAX;
    unsigned long long top = 0;
    for (int h = 0; h < g; ++h) {
      const int32_t* o = scratch + kMergeWords * static_cast<size_t>(h);
      if (o[kMNode] != node) continue;
      ++claims;
      rep &= h >= j;
      const unsigned long long rank =
          (static_cast<unsigned long long>(static_cast<uint32_t>(o[kMPrio])) << 32) |
          static_cast<uint32_t>(o[kMU]);
      if (rank > top) {
        top = rank;
        least = h;
      }
    }
    const bool finite = key_value(static_cast<uint32_t>(top)) > -INFINITY;
    const int won = finite ? least : (zero_node == node ? 0 : -1);
    if (won == j) {
      const int slot = min(placed[j], max_c - 1);
      choices[static_cast<size_t>(j) * max_c + slot] = node;
      choice_scores[static_cast<size_t>(j) * max_c + slot] = __int_as_float(w[kMScore]);
      placed[j] += 1;
    } else {
      waits[j] += 1;
    }
    w[kMRep] = rep;
    w[kMClaims] = claims;
    w[kMWon] = won;
    w[kMAsk] = finite ? least : 0;
    if (rep) atomicAdd(&s_m, 1);
  }
  __syncthreads();
  // the claimed nodes' entries, sorted by node
  for (int j = threadIdx.x; j < g; j += kThreads) {
    const int32_t* w = scratch + kMergeWords * static_cast<size_t>(j);
    if (w[kMNode] < 0 || !w[kMRep]) continue;
    int at = 0;
    for (int h = 0; h < g; ++h) {
      const int32_t* o = scratch + kMergeWords * static_cast<size_t>(h);
      at += o[kMNode] >= 0 && o[kMRep] && o[kMNode] < w[kMNode];
    }
    int32_t* e = record + kRecHead + kEntry * static_cast<size_t>(at);
    const int won = w[kMWon];
    e[0] = w[kMNode];
    e[1] = w[kMClaims];
    e[2] = won;
    e[3] = won >= 0 ? job_code[won] : -1;
    e[4] = won >= 0 && gang_code != nullptr ? gang_code[won] : -1;
    for (int l = 0; l < 3; ++l) e[5 + l] = w[kMIds + l];
    for (int d = 0; d < 4; ++d) {
      e[8 + d] = __float_as_int(asks[4 * static_cast<size_t>(w[kMAsk]) + d]);
    }
  }
  if (threadIdx.x == 0) {
    record[0] = progress ? 0 : 1;
    record[1] = s_m;
    if (progress) rounds[0] += 1;
  }
}

// The claimed node `node`'s entry among the record's M, sorted by node.
__device__ const int32_t* find_entry(const int32_t* record, int node) {
  int lo = 0;
  int hi = record[1];
  const int32_t* entries = record + kRecHead;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (entries[kEntry * static_cast<size_t>(mid)] < node) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < record[1] && entries[kEntry * static_cast<size_t>(lo)] == node
             ? entries + kEntry * static_cast<size_t>(lo)
             : nullptr;
}

template <bool kGang>
__global__ void __launch_bounds__(kThreads)
    cp_shard_settle_kernel(CpCell c, const int32_t* record, int col0, int g0) {
  if (record[0] == 2) return;
  const int n = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (n < c.n) {
    const int32_t* e = find_entry(record, col0 + n);
    const int count = e != nullptr ? e[1] : 0;
    for (int d = 0; d < 4; ++d) {
      float* u = c.used + 4 * static_cast<size_t>(n) + d;
      *u = __fadd_rn(*u, count > 0 ? __int_as_float(e[8 + d]) : 0.0f);
    }
    float l = __fadd_rn(c.lam[n], __fmul_rn(kEta, __int2float_rn(max(count - 1, 0))));
    if (count == 0) l = fmaxf(__fsub_rn(l, kEta), 0.0f);
    c.lam[n] = l;
    if (e != nullptr && e[2] >= 0) {
      // one winner a node: no other thread touches these words
      c.sib[static_cast<size_t>(e[3]) * c.n + n] += 1;
      const int row = e[2] - g0;
      if (row >= 0 && row < c.g) c.assigned[static_cast<size_t>(row) * c.n + n] += 1;
    }
  }
  if (blockIdx.x != 0) return;
  const int m = record[1];
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const int32_t* e = record + kRecHead + kEntry * static_cast<size_t>(k);
    if (e[2] < 0) continue;
    const int row = e[2] - g0;
    if (row >= 0 && row < c.g) c.placed[row] += 1;  // a group wins one node a round
    if (kGang && e[4] >= 0) {
      const size_t gc = static_cast<size_t>(e[4]);
      if (e[5] > 0) atomicAdd(c.t_rack + gc * c.wr + e[5], 1);
      if (e[6] > 0) atomicAdd(c.t_pod + gc * c.wp + e[6], 1);
      if (e[7] > 0) atomicAdd(c.t_ici + gc * c.wi + e[7], 1);
    }
  }
}

// The launch just made: its error, and one more in `launched` (when
// given) if it was accepted.
cudaError_t launched_ok(long long* launched) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && launched != nullptr) ++*launched;
  return e;
}

cudaError_t launch_claim(bool gang, const CpCell& c, const int32_t* record, int col0,
                         int32_t* cand, cudaStream_t st, long long* launched) {
  if (c.g == 0) return cudaSuccess;
  if (gang) {
    cp_shard_claim_kernel<true><<<c.g, kThreads, 0, st>>>(c, record, col0, cand);
  } else {
    cp_shard_claim_kernel<false><<<c.g, kThreads, 0, st>>>(c, record, col0, cand);
  }
  return launched_ok(launched);
}

cudaError_t launch_settle(bool gang, const CpCell& c, const int32_t* record, int col0, int g0,
                          cudaStream_t st, long long* launched) {
  const unsigned blocks = static_cast<unsigned>((c.n + kThreads - 1) / kThreads);
  if (gang) {
    cp_shard_settle_kernel<true><<<blocks, kThreads, 0, st>>>(c, record, col0, g0);
  } else {
    cp_shard_settle_kernel<false><<<blocks, kThreads, 0, st>>>(c, record, col0, g0);
  }
  return launched_ok(launched);
}

// The per-cell pointers the round loop takes, in this order.
enum CpPtr {
  kPCapacity, kPAsks, kPCounts, kPEligible, kPScores, kPJobCounts, kPDistinct, kPJobCode,
  kPGangCode, kPQRack, kPQPod, kPQIci, kPLevelIds,
  kPUsed,           // f32 [n, 4]: the cell's copy of its nodes' usage, used0 at the start
  kPLam,            // f32 [n]: the cell's copy of its nodes' prices, lam0 at the start
  kPAssigned,       // i32 [g, n], zero at the start
  kPSib,            // i32 [jobs, n], zero at the start
  kPTRack, kPTPod, kPTIci,  // i32 [gangs, w], zero at the start (gang only)
  kPPlaced,         // i32 [g], zero at the start
  kPCand,           // i32 [g, kCand]
  kPRecord,         // i32 [kRecHead + G kEntry]: the round's record as the cell received it
  kPGathered,       // the lead only: i32 [mp, G, kCand]
  kPEveryPrio,      // the lead only: f32 [G]
  kPEveryAsks,      // the lead only: f32 [G, 4]
  kPEveryJobCode,   // the lead only: i32 [G]
  kPEveryGangCode,  // the lead only: i32 [G] (gang only)
  kPLeadPlaced,     // the lead only: i32 [G], zero at the start
  kPWaits,          // the lead only: i32 [G], zero at the start
  kPRounds,         // the lead only: i32 [1], zero at the start
  kPChoices,        // the lead only: i32 [G, C], -1 at the start
  kPChoiceScores,   // the lead only: f32 [G, C], 0 at the start
  kPMaster,         // the lead only: the record, zero at the start
  kPMergeScratch,   // the lead only: i32 [G, kMergeWords]
  kPHomeStream,     // the stream the cell's tensors were made on
  kPCellPtrs
};

// The entries of the round loop's launch counts.
enum PLaunched { kPLaunchedClaim, kPLaunchedMerge, kPLaunchedSettle };

// The sharded auction of one call: `rows` groups rows of `mp` cells each
// (cell (i, j) is index i * mp + j, cell 0 the mesh lead), `gseg` groups
// a row over `seg` nodes a cell (mesh_loop.cuh runs the rounds). Launches
// per round: a claim and a settle a cell, one merge. `launched` [3]
// gains the claims, merges and settles, counted where each launches.
int cp_sharded(int rows, int mp, const int* devices, void* const* ptrs, int gseg, int seg,
               int wr, int wp, int wi, bool gang, int steps, int max_c, int32_t* poll,
               long long* launched) {
  const int cells = rows * mp;
  const int g = rows * gseg;
  const auto P = [&](int cell, int k) { return ptrs[static_cast<size_t>(cell) * kPCellPtrs + k]; };
  std::vector<void*> home(cells);
  for (int c = 0; c < cells; ++c) home[c] = P(c, kPHomeStream);
  MeshLoop loop(cells, devices, home);
  const auto cell = [&](int c) {
    CpCell x{};
    x.capacity = static_cast<const float*>(P(c, kPCapacity));
    x.asks = static_cast<const float*>(P(c, kPAsks));
    x.counts = static_cast<const int32_t*>(P(c, kPCounts));
    x.eligible = static_cast<const uint8_t*>(P(c, kPEligible));
    x.scores = static_cast<const float*>(P(c, kPScores));
    x.job_counts = static_cast<const int32_t*>(P(c, kPJobCounts));
    x.distinct = static_cast<const uint8_t*>(P(c, kPDistinct));
    x.job_code = static_cast<const int32_t*>(P(c, kPJobCode));
    x.gang_code = static_cast<const int32_t*>(P(c, kPGangCode));
    x.q_rack = static_cast<const int32_t*>(P(c, kPQRack));
    x.q_pod = static_cast<const int32_t*>(P(c, kPQPod));
    x.q_ici = static_cast<const int32_t*>(P(c, kPQIci));
    x.level_ids = static_cast<const int32_t*>(P(c, kPLevelIds));
    x.used = static_cast<float*>(P(c, kPUsed));
    x.lam = static_cast<float*>(P(c, kPLam));
    x.assigned = static_cast<int32_t*>(P(c, kPAssigned));
    x.sib = static_cast<int32_t*>(P(c, kPSib));
    x.t_rack = static_cast<int32_t*>(P(c, kPTRack));
    x.t_pod = static_cast<int32_t*>(P(c, kPTPod));
    x.t_ici = static_cast<int32_t*>(P(c, kPTIci));
    x.placed = static_cast<int32_t*>(P(c, kPPlaced));
    x.wr = wr;
    x.wp = wp;
    x.wi = wi;
    x.g = gseg;
    x.n = seg;
    return x;
  };
  for (int it = 0; it < steps && loop.go_on(it, kPollRounds, poll, P(0, kPMaster)); ++it) {
    loop.step(
        [&](int c, cudaStream_t st) {
          return launch_claim(gang, cell(c), static_cast<const int32_t*>(P(c, kPRecord)),
                              c % mp * seg, static_cast<int32_t*>(P(c, kPCand)), st,
                              launched + kPLaunchedClaim);
        },
        static_cast<size_t>(gseg) * kCand * 4, [&](int c) { return P(c, kPCand); },
        [&](int c) {
          // column j's candidates for groups [i gseg, (i + 1) gseg) of [mp, G]
          return static_cast<char*>(P(0, kPGathered)) +
                 (static_cast<size_t>(c % mp) * g + static_cast<size_t>(c / mp) * gseg) * kCand *
                     4;
        },
        [&](cudaStream_t st) {
          cp_round_merge_kernel<<<1, kThreads, 0, st>>>(
              static_cast<const int32_t*>(P(0, kPGathered)), mp, g,
              static_cast<const float*>(P(0, kPEveryPrio)),
              static_cast<const float*>(P(0, kPEveryAsks)),
              static_cast<const int32_t*>(P(0, kPEveryJobCode)),
              static_cast<const int32_t*>(P(0, kPEveryGangCode)), max_c,
              static_cast<int32_t*>(P(0, kPLeadPlaced)), static_cast<int32_t*>(P(0, kPWaits)),
              static_cast<int32_t*>(P(0, kPRounds)), static_cast<int32_t*>(P(0, kPChoices)),
              static_cast<float*>(P(0, kPChoiceScores)), static_cast<int32_t*>(P(0, kPMaster)),
              static_cast<int32_t*>(P(0, kPMergeScratch)));
          return launched_ok(launched + kPLaunchedMerge);
        },
        P(0, kPMaster), (kRecHead + static_cast<size_t>(g) * kEntry) * 4,
        [&](int c) { return P(c, kPRecord); },
        [&](int c, cudaStream_t st) {
          return launch_settle(gang, cell(c), static_cast<const int32_t*>(P(c, kPRecord)),
                               c % mp * seg, c / mp * gseg, st, launched + kPLaunchedSettle);
        });
  }
  return loop.finish();
}

}  // namespace

// C entry points, bound with ctypes (nomad_tpu_torch/device/cp.py).

// Words of the zero-filled int32 scratch `nomad_cp_place` takes for these
// sizes; a negative cudaError on failure.
extern "C" long long nomad_cp_scratch_words(int g, int n, int jobs, int gangs,
                                             int wr, int wp, int wi, int gang) {
  if (g < 1 || n < 1 || jobs < 1) return -static_cast<long long>(cudaErrorInvalidValue);
  return layout(g, n, jobs, gangs, wr, wp, wi, gang != 0).total;
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
  const Layout l = layout(g, n, jobs, gangs, wr, wp, wi, gang);
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
  c.vec = reinterpret_cast<uintptr_t>(used) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(capacity) % 16 == 0;
  c.barrier = reinterpret_cast<unsigned*>(scratch);
  c.placed = scratch + l.placed;
  c.assigned = scratch + l.assigned;
  c.sib = scratch + l.sib;
  c.t_rack = scratch + l.t_rack;
  c.t_pod = scratch + l.t_pod;
  c.t_ici = scratch + l.t_ici;
  c.claim = reinterpret_cast<unsigned long long*>(scratch + l.claim);
  c.any = scratch + l.any;
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

// `iters` grid barriers in one cooperative launch of the auction's grid
// (one 1,024-thread block per SM) on `stream`; `scratch` holds 2 zeroed
// words. Returns the launch's error.
extern "C" int nomad_cp_barrier_probe(int iters, int32_t* scratch, void* stream) {
  if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0, segs = 0, seg_len = 0;
  cudaError_t e = plan(1, 1, &grid, &segs, &seg_len);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  void* args[] = {&bar, &iters};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_probe_kernel),
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// -- the mesh kernels' entry points ------------------------------------------

// One cell's candidates for a round; the gang term is on when `gang_code`
// is not null.
extern "C" int nomad_cp_shard_claim(
    const float* capacity, const float* used, const float* asks, const int32_t* counts,
    const uint8_t* eligible, const float* scores, const int32_t* job_counts,
    const uint8_t* distinct, const int32_t* job_code, const float* lam, const int32_t* assigned,
    const int32_t* sib, const int32_t* placed, const int32_t* gang_code, const int32_t* q_rack,
    const int32_t* q_pod, const int32_t* q_ici, const int32_t* level_ids, const int32_t* t_rack,
    const int32_t* t_pod, const int32_t* t_ici, int wr, int wp, int wi, int g, int n, int col0,
    int32_t* cand, void* stream) {
  const bool gang = gang_code != nullptr;
  if (g < 0 || n < 1 || (gang && (wr < 1 || wp < 1 || wi < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CpCell c{capacity, asks, counts, eligible, scores, job_counts, distinct, job_code, gang_code,
           q_rack, q_pod, q_ici, level_ids, const_cast<float*>(used), const_cast<float*>(lam),
           const_cast<int32_t*>(assigned), const_cast<int32_t*>(sib),
           const_cast<int32_t*>(t_rack), const_cast<int32_t*>(t_pod),
           const_cast<int32_t*>(t_ici), const_cast<int32_t*>(placed), wr, wp, wi, g, n};
  return static_cast<int>(
      launch_claim(gang, c, nullptr, col0, cand, static_cast<cudaStream_t>(stream), nullptr));
}

// One round's merge on the mesh lead over `cells` columns of `g` groups'
// candidates; `record` holds the previous round's state and zeros.
extern "C" int nomad_cp_round_merge(
    const int32_t* cand, int cells, int g, const float* prio, const float* asks,
    const int32_t* job_code, const int32_t* gang_code, int max_c, int32_t* placed,
    int32_t* waits, int32_t* rounds, int32_t* choices, float* choice_scores, int32_t* record,
    int32_t* scratch, void* stream) {
  if (cells < 1 || g < 1 || max_c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cp_round_merge_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cand, cells, g, prio, asks, job_code, gang_code, max_c, placed, waits, rounds, choices,
      choice_scores, record, scratch);
  return static_cast<int>(cudaGetLastError());
}

// One cell's state after a round; the topology tables move when `t_rack`
// is not null.
extern "C" int nomad_cp_shard_settle(
    const int32_t* record, float* used, float* lam, int32_t* assigned, int32_t* sib,
    int32_t* placed, int32_t* t_rack, int32_t* t_pod, int32_t* t_ici, int wr, int wp, int wi,
    int n, int g, int col0, int g0, void* stream) {
  if (n < 1 || g < 0) return static_cast<int>(cudaErrorInvalidValue);
  CpCell c{};
  c.used = used;
  c.lam = lam;
  c.assigned = assigned;
  c.sib = sib;
  c.placed = placed;
  c.t_rack = t_rack;
  c.t_pod = t_pod;
  c.t_ici = t_ici;
  c.wr = wr;
  c.wp = wp;
  c.wi = wi;
  c.g = g;
  c.n = n;
  return static_cast<int>(launch_settle(t_rack != nullptr, c, record, col0, g0,
                                        static_cast<cudaStream_t>(stream), nullptr));
}

// The round loop: `ptrs` holds kPCellPtrs pointers a cell (CpPtr order),
// `devices` each cell's device, `poll` one pinned int32, `launched`
// i64[3] added to; see cp_sharded.
extern "C" int nomad_sharded_cp(int rows, int mp, const int* devices, void* const* ptrs,
                                int gseg, int seg, int jobs, int gangs, int wr, int wp, int wi,
                                int gang, int steps, int max_c, int32_t* poll,
                                long long* launched) {
  if (rows < 1 || mp < 1 || gseg < 1 || seg < 1 || jobs < 1 || gangs < 1 || max_c < 1 ||
      (gang && (wr < 1 || wp < 1 || wi < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cp_sharded(rows, mp, devices, ptrs, gseg, seg, wr, wp, wi, gang != 0,
                                     steps, max_c, poll, launched));
}

// The per-cell pointer count the round loop reads.
extern "C" int nomad_cp_cell_ptrs() { return kPCellPtrs; }
