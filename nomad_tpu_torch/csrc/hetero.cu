// Joint heterogeneity-aware greedy placement on Hopper (sm_90a).
//
// Replaces nomad_tpu/scheduler/hetero.py:hetero_place_kernel.
//
// The pass is a chain of dependent greedy steps. Each step: feasibility
// of every (group, node) (room for one more instance in every dimension,
// eligible, throughput > 0); among the groups still short of their count
// with a feasible node, the one with the least policy key (first index on
// ties) — maxmin: accum / max(count * tpmax, 1e-9), makespan:
// -(count / max(accum, 1e-9)), cost: -(count - placed); its node is the
// feasible one with the greatest node key (tp, or tp / max(cost, 1e-9)
// under cost; first index on ties); commit: the node's usage grows by the
// group's ask, the slot takes the node and its throughput, the group's
// accumulated rate grows by it.
//
// What bounds it on the H100: the chain. Each step depends on the last
// through the usage and the per-group state, so its time is steps x the
// latency of a step, far above both the bytes it must move and its
// operations. The design cuts a step to a few dependent loads.
//
// A node's key for a group does not depend on the pass's state, and a
// commit changes the usage of one node only. So each row (group) keeps
// its eligible nodes with tp > 0 in one list, ordered by the 64-bit word
// (order_key(node key) << 32 | ~node) descending — key desc, index asc —
// and a pointer to its head, the first entry that fits. Every entry
// before the pointer does not fit. When every ask is >= 0 (checked in the
// kernel; -0.0 counts as >= 0) usage only grows and feasibility only
// turns off, so the pointer only moves forward, and only for the rows
// whose head is the committed node and no longer fits there.
//
// Three launches a pass:
//  1. Sort (a block a 2,048-node chunk of a row, so a row's build spreads
//     over N / 2,048 SMs even at G 1): each node's word, a bitonic sort
//     in registers, warp shuffles (strides to 32 words) and shared memory
//     (longer strides), its stages unrolled, the chunk written back in
//     order.
//  2. Merge (the same blocks): each word's place in the row is its place
//     in its chunk plus, for every other chunk, the words there that
//     order before it (a branchless binary search, eight chunks and both
//     of a thread's words at once).
//     Whole rows are sorted: the walks in a pass cover up to ~400 entries
//     of a row at G 100 and 7 at a time (measured on the CPU on
//     chip_smoke.py's inputs), so a head of the row with a dense fallback
//     would save little sort work and add the fallback.
//  3. The chain, by G:
//   - G <= 32 (the paths' G 1 and 30): one warp, a lane a row, every
//     per-row value in registers (chain_warp_kernel). A step: the least
//     job key by one warp reduction of order keys and a ballot for the
//     first index, the commit by shuffles from the row's lane, every lane
//     checking its own row. Each row also keeps the list entry after its
//     head with that node's usage and capacity, so a head that stops
//     fitting moves on without a load where the next entry fits (at least
//     95 % of the moves at G 30 on chip_smoke.py's inputs, by the CPU
//     model in tests/test_torch_hetero_walk.py); otherwise the whole warp
//     walks that row's list 32 entries at a time. No shared memory, no
//     barrier.
//   - Larger G: one block of 1,024 threads (chain_kernel). Per group it
//     keeps the head (position and word), placed, accum, count, tpmax,
//     the ask and the cached job key (+inf once the group is done or its
//     list is spent) in shared memory — in a global scratch when G is too
//     large for it (above ~4,000). A step, warp 0 alone: the argmin (each
//     lane's first least key, then the warp's by reduction); the commit
//     (lanes 0-3 one dimension each of the node's usage); the rows whose
//     head is the committed node and no longer fits it are queued. Steps
//     whose queue is empty run back to back with no barrier; otherwise
//     one barrier hands the queue to every warp, a warp a row walking its
//     list 32 entries at a time from the old head and gathering usage and
//     capacity only for those entries; a second barrier, and warp 0 steps
//     on.
//  The pass stops at the first step where nothing is placeable: that step
//  commits nothing, so every later step of the reference is the same
//  no-op.
//
// When an ask is negative (or NaN) a commit can make its node fit again
// behind a row's pointer. Such a pass also checks, every step, the
// committed node's column for every unfinished row: a row for which the
// node now fits and orders before its head (or whose list was spent)
// takes it as its head, its position found by a binary search of the
// list. The invariant — nothing before the head fits — holds either way.
//
// Numerics: IEEE division (__fdiv_rn), separately rounded adds and
// multiplies in the reference's order, and the build's -fmad=false. The
// kernel assumes finite keys (finite throughputs and costs), as every
// caller gives it.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include <vector>

#include "mesh_loop.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2 * kThreads;  // nodes a build block sorts
constexpr int kWays = 8;              // chunks a merge thread searches at once
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kNone = ~0ull;          // a sorted slot without a node
constexpr float kEps = 1e-9f;
constexpr int kMaxmin = 0;
constexpr int kMakespan = 1;
constexpr int kCost = 2;
constexpr int kWalk = 0;              // queued row: walk on from its head
constexpr int kAdopt = 1;             // queued row: the committed node is its head

struct Hetero {
  const float* capacity;   // [N, 4]
  const float* asks;       // [G, 4]
  const int32_t* counts;   // [G]
  const uint8_t* eligible; // [G, N]
  const float* tp;         // [G, N]
  const float* tpmax;      // [G]
  const float* cost;       // [N]
  int policy;
  int g;
  int n;
  int steps;
  int max_c;
  int chunks;              // ceil(N / kChunk)
  u64* sorted;             // [G, chunks * kChunk]: ~word, each chunk ascending
  u64* lists;              // [G, chunks * kChunk]: words, descending
  int32_t* len;            // [G]: entries in each list
  unsigned char* state;    // the chain's state when shared memory is too small
  int32_t* choices;        // [G, C]
  float* choice_tp;        // [G, C]
  float* used;             // [N, 4], holds used0 on entry
};

// The chain's per-group state (the block form).
struct State {
  u64* hword;       // head's word, 0 = the list is spent
  float* jkey;      // cached job key, +inf = not placeable
  float* accum;
  float* tpmax;
  float* ask;       // [G, 4]
  int32_t* pos;     // head's position in the list
  int32_t* placed;
  int32_t* count;
  int32_t* len;
  int32_t* queue;   // 2 * row + kWalk / kAdopt
};

__host__ __device__ size_t state_bytes(int g) {
  return static_cast<size_t>(g) * (8 + 3 * 4 + 16 + 5 * 4);
}

__device__ State carve(unsigned char* base, int g) {
  State s;
  s.hword = reinterpret_cast<u64*>(base);
  float* f = reinterpret_cast<float*>(s.hword + g);
  s.jkey = f;
  s.accum = f + g;
  s.tpmax = f + 2 * g;
  s.ask = f + 3 * g;
  int32_t* i = reinterpret_cast<int32_t*>(f + 7 * g);
  s.pos = i;
  s.placed = i + g;
  s.count = i + 2 * g;
  s.len = i + 3 * g;
  s.queue = i + 4 * g;
  return s;
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

// A larger word: a larger node key, then a lower node. A key is >= +0
// here (tp > 0), so every word is >= 2^63 and 0 is free for "none".
__device__ __forceinline__ u64 node_word(float key, int n) {
  return (static_cast<u64>(order_key(key)) << 32) | (kFull - static_cast<uint32_t>(n));
}

__device__ __forceinline__ int word_node(u64 w) {
  return static_cast<int>(kFull - static_cast<uint32_t>(w));
}

__device__ __forceinline__ float node_key(const Hetero& h, int g, int n) {
  const float t = h.tp[static_cast<size_t>(g) * h.n + n];
  return h.policy == kCost ? __fdiv_rn(t, fmaxf(h.cost[n], kEps)) : t;
}

__device__ __forceinline__ float job_key(int policy, int count, float tpmax,
                                         int placed, float acc) {
  const float c = __int2float_rn(count);
  if (policy == kMaxmin) return __fdiv_rn(acc, fmaxf(__fmul_rn(c, tpmax), kEps));
  if (policy == kMakespan) return -__fdiv_rn(c, fmaxf(acc, kEps));
  return -__fsub_rn(c, __int2float_rn(placed));
}

// Room for one more instance of ask `a` on a node at usage `u`.
__device__ __forceinline__ bool room(const float* u, const float* cap, const float* a) {
  bool ok = true;
  for (int d = 0; d < 4; ++d) ok &= __fadd_rn(u[d], a[d]) <= cap[d];
  return ok;
}

__device__ __forceinline__ size_t row_stride(const Hetero& h) {
  return static_cast<size_t>(h.chunks) * kChunk;
}

// -- the lists ----------------------------------------------------------------

// Sorts kChunk words ascending, two a thread (positions 2t and 2t + 1,
// in `w` on entry and on return): strides up to 32 words in registers
// and warp shuffles, longer ones through shared memory `s`.
__device__ void sort_chunk(u64 (&w)[2], u64* s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int size = 2; size <= kChunk; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 64) {  // the partner is in another warp
        __syncthreads();
        s[2 * tid] = w[0];
        s[2 * tid + 1] = w[1];
        __syncthreads();
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = 2 * tid + b;
        u64 o;
        if (stride == 1) {
          o = w[b ^ 1];
        } else if (stride < 64) {
          o = __shfl_xor_sync(kFull, w[b], stride >> 1);
        } else {
          o = s[i ^ stride];
        }
        const bool keep_min = ((i & stride) == 0) == ((i & size) == 0);
        const u64 lo = o < w[b] ? o : w[b];
        const u64 hi = o < w[b] ? w[b] : o;
        o = keep_min ? lo : hi;
        if (stride == 1) {
          // both words of the pair are this thread's: decide once
          if (b == 0) {
            w[1] = keep_min ? hi : lo;
            w[0] = o;
          }
        } else {
          w[b] = o;
        }
      }
    }
  }
}

// Launch 1: block (row, chunk) sorts the chunk's words, complemented so
// that ascending order is the list's order and empty slots (kNone) sort
// last.
__global__ void __launch_bounds__(kThreads) sort_kernel(Hetero h) {
  __shared__ u64 s[kChunk];
  const int g = static_cast<int>(blockIdx.x) / h.chunks;
  const int chunk = static_cast<int>(blockIdx.x) % h.chunks;
  const size_t row = static_cast<size_t>(g) * h.n;
  u64 w[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int n = chunk * kChunk + 2 * static_cast<int>(threadIdx.x) + b;
    w[b] = kNone;
    if (n < h.n && h.eligible[row + n] && h.tp[row + n] > 0.0f) {
      w[b] = ~node_word(node_key(h, g, n), n);
    }
  }
  sort_chunk(w, s);
  u64* out = h.sorted + g * row_stride(h) + static_cast<size_t>(chunk) * kChunk;
  out[2 * threadIdx.x] = w[0];
  out[2 * threadIdx.x + 1] = w[1];
  if (chunk == 0 && threadIdx.x == 0) h.len[g] = 0;
}

// Launch 2: each word's place in its row — its place in its chunk plus,
// for every other chunk, the words there below it (a branchless lower
// bound over the kChunk slots; empty slots are above every word), both
// words of a thread and kWays chunks searched at once.
__global__ void __launch_bounds__(kThreads) merge_kernel(Hetero h) {
  const int g = static_cast<int>(blockIdx.x) / h.chunks;
  const int chunk = static_cast<int>(blockIdx.x) % h.chunks;
  const u64* src = h.sorted + g * row_stride(h);
  u64 w[2];
  int rank[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    rank[b] = static_cast<int>(threadIdx.x) + b * kThreads;
    w[b] = src[static_cast<size_t>(chunk) * kChunk + rank[b]];
  }
  for (int c0 = 0; c0 < h.chunks; c0 += kWays) {
    int lo[2][kWays];
#pragma unroll
    for (int k = 0; k < kWays; ++k) lo[0][k] = lo[1][k] = 0;
#pragma unroll
    for (int half = kChunk / 2; half > 0; half >>= 1) {
#pragma unroll
      for (int k = 0; k < kWays; ++k) {
        const int c = c0 + k;
        if (c < h.chunks && c != chunk) {
          const u64* cw = src + static_cast<size_t>(c) * kChunk + half - 1;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (cw[lo[b][k]] < w[b]) lo[b][k] += half;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWays; ++k) {
      const int c = c0 + k;
      if (c < h.chunks && c != chunk) {
        const u64* cw = src + static_cast<size_t>(c) * kChunk;
#pragma unroll
        for (int b = 0; b < 2; ++b) rank[b] += lo[b][k] + (cw[lo[b][k]] < w[b] ? 1 : 0);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (w[b] == kNone) continue;
    h.lists[g * row_stride(h) + rank[b]] = ~w[b];
    // the chunk's last word sets the row's length
    const int i = static_cast<int>(threadIdx.x) + b * kThreads;
    if (i == kChunk - 1 || src[static_cast<size_t>(chunk) * kChunk + i + 1] == kNone) {
      atomicMax(h.len + g, rank[b] + 1);
    }
  }
}

// -- the chain ----------------------------------------------------------------

// Warp: row g's head from list position `start` on, the first entry that
// fits; spent lists take the row out.
__device__ void walk(const Hetero& h, const State& s, int g, int start) {
  const int lane = threadIdx.x & 31;
  const int len = s.len[g];
  const u64* list = h.lists + g * row_stride(h);
  const float* a = s.ask + 4 * static_cast<size_t>(g);
  for (int base = start; base < len; base += 32) {
    const int i = base + lane;
    u64 w = 0;
    bool ok = false;
    if (i < len) {
      w = list[i];
      const size_t n4 = 4 * static_cast<size_t>(word_node(w));
      ok = room(h.used + n4, h.capacity + n4, a);
    }
    const unsigned m = __ballot_sync(kFull, ok);
    if (m != 0u) {
      const int src = __ffs(m) - 1;
      const u64 hw = __shfl_sync(kFull, w, src);
      if (lane == 0) {
        s.pos[g] = base + src;
        s.hword[g] = hw;
      }
      return;
    }
  }
  if (lane == 0) {
    s.pos[g] = len;
    s.hword[g] = 0;
    s.jkey[g] = INFINITY;
  }
}

// Lane 0: row g's head becomes node x, which now fits and orders before
// the old head; its position by binary search.
__device__ void adopt(const Hetero& h, const State& s, int g, int x) {
  const u64 w = node_word(node_key(h, g, x), x);
  const u64* list = h.lists + g * row_stride(h);
  int lo = 0;
  int hi = s.len[g];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] > w) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  s.pos[g] = lo;
  s.hword[g] = w;
  s.jkey[g] = job_key(h.policy, s.count[g], s.tpmax[g], s.placed[g], s.accum[g]);
}

__global__ void __launch_bounds__(kThreads) chain_kernel(Hetero h, int in_smem) {
  extern __shared__ u64 smem_words[];
  __shared__ int s_nq;
  __shared__ int s_done;
  __shared__ int s_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const State s = carve(in_smem ? reinterpret_cast<unsigned char*>(smem_words) : h.state, h.g);

  int negative = 0;
  for (int i = threadIdx.x; i < 4 * h.g; i += kThreads) {
    const float a = h.asks[i];
    s.ask[i] = a;
    negative |= !(a >= 0.0f);
  }
  for (int g = threadIdx.x; g < h.g; g += kThreads) {
    const int count = h.counts[g];
    const float tpmax = h.tpmax[g];
    s.count[g] = count;
    s.tpmax[g] = tpmax;
    s.placed[g] = 0;
    s.accum[g] = 0.0f;
    s.len[g] = h.len[g];
    s.jkey[g] = count > 0 ? job_key(h.policy, count, tpmax, 0, 0.0f) : INFINITY;
  }
  // usage only grows when no ask is below 0: heads only move forward
  const bool monotone = __syncthreads_or(negative) == 0;
  for (int g = warp; g < h.g; g += kWarps) walk(h, s, g, 0);  // every row's first head
  __syncthreads();

  const uint32_t none = order_key(INFINITY);
  int step = 0;  // warp 0's
  for (;;) {
    if (warp == 0) {
      int nq = 0;
      bool done = false;
      int x = 0;
      for (;;) {
        if (step >= h.steps) {
          done = true;
          break;
        }
        // the group: least cached job key, first index (a lane's first
        // least key, then the warp's as order keys by reduction)
        float bk = INFINITY;
        int bj = INT_MAX;
        for (int g = lane; g < h.g; g += 32) {
          const float k = s.jkey[g];
          if (k < bk) {
            bk = k;
            bj = g;
          }
        }
        const uint32_t key = bj == INT_MAX ? none : order_key(bk);
        const uint32_t least = __reduce_min_sync(kFull, key);
        if (least >= none) {  // nothing placeable
          done = true;
          break;
        }
        ++step;
        const int j = __reduce_min_sync(kFull, key == least ? bj : INT_MAX);
        const u64 hw = s.hword[j];
        x = word_node(hw);
        // commit: lane d < 4 grows the node's usage in dimension d
        const size_t x4 = 4 * static_cast<size_t>(x);
        float nu = 0.0f;
        if (lane < 4) {
          nu = __fadd_rn(h.used[x4 + lane], s.ask[4 * static_cast<size_t>(j) + lane]);
          h.used[x4 + lane] = nu;
        }
        float u[4];
        float cap[4];
        for (int d = 0; d < 4; ++d) {
          u[d] = __shfl_sync(kFull, nu, d);
          cap[d] = h.capacity[x4 + d];
        }
        if (lane == 0) {
          const int slot = s.placed[j];
          const float t = h.tp[static_cast<size_t>(j) * h.n + x];
          h.choices[static_cast<size_t>(j) * h.max_c + slot] = x;
          h.choice_tp[static_cast<size_t>(j) * h.max_c + slot] = t;
          const float acc = __fadd_rn(s.accum[j], t);
          s.placed[j] = slot + 1;
          s.accum[j] = acc;
          s.jkey[j] = slot + 1 < s.count[j]
              ? job_key(h.policy, s.count[j], s.tpmax[j], slot + 1, acc)
              : INFINITY;
        }
        __syncwarp();
        // column x changed: queue the rows whose head no longer fits
        // there (and, with a negative ask, the rows it now fits before
        // their head)
        for (int base = 0; base < h.g; base += 32) {
          const int g = base + lane;
          int mode = -1;
          if (g < h.g) {
            const float* a = s.ask + 4 * static_cast<size_t>(g);
            const u64 gw = s.hword[g];
            const bool on_x = gw != 0 && static_cast<uint32_t>(gw) == static_cast<uint32_t>(hw);
            const bool live = monotone ? s.jkey[g] != INFINITY : s.placed[g] < s.count[g];
            if (live && on_x) {
              if (!room(u, cap, a)) mode = kWalk;
            } else if (live && !monotone) {
              const size_t gx = static_cast<size_t>(g) * h.n + x;
              if (h.eligible[gx] && h.tp[gx] > 0.0f && room(u, cap, a) &&
                  node_word(node_key(h, g, x), x) > gw) {
                mode = kAdopt;
              }
            }
          }
          const unsigned m = __ballot_sync(kFull, mode >= 0);
          if (mode >= 0) s.queue[nq + __popc(m & ((1u << lane) - 1u))] = 2 * g + mode;
          nq += __popc(m);
        }
        if (step >= h.steps) {
          done = true;
          break;
        }
        if (nq > 0) break;
      }
      if (lane == 0) {
        s_nq = nq;
        s_done = done;
        s_x = x;
      }
    }
    __syncthreads();
    if (s_done) break;
    // the queued rows, a warp each
    for (int i = warp; i < s_nq; i += kWarps) {
      const int e = s.queue[i];
      if ((e & 1) == kWalk) {
        walk(h, s, e >> 1, s.pos[e >> 1] + 1);
      } else if (lane == 0) {
        adopt(h, s, e >> 1, s_x);
      }
    }
    __syncthreads();
  }
}

// -- the chain in one warp (G <= 32) -------------------------------------------
//
// A lane a row: every per-row value in registers, the argmin and the
// commit by shuffles, so a step touches no shared memory and waits on no
// barrier. Beside its head each row keeps the entry after it (word,
// usage, capacity, tp), loaded as soon as the head is set and given the
// new usage when a commit lands on its node, so a head that stops
// fitting usually moves on to it without a load; only when it does not
// fit either does the warp walk that row's list 32 entries at a time.

struct Row {
  u64 hword;   // head, 0 = the list is spent
  int pos;
  float hu[4];  // usage, capacity and tp of the head's node
  float hc[4];
  float htp;
  u64 nword;   // the entry after the head, 0 = none
  int npos;
  float nu[4];
  float nc[4];
  float ntp;
};

__device__ __forceinline__ float entry_tp(const Hetero& h, int g, u64 w) {
  // the word holds tp itself unless the policy divides it by the cost
  return h.policy == kCost ? h.tp[static_cast<size_t>(g) * h.n + word_node(w)]
                           : key_value(static_cast<uint32_t>(w >> 32));
}

// Lane g: the entry after the head, with its node's usage and capacity
// (the loads are issued, and waited on only where they are used).
__device__ void load_next(const Hetero& h, int g, int len, Row& r) {
  r.npos = r.pos + 1;
  r.nword = 0;
  if (r.npos < len) {
    const u64 w = h.lists[g * row_stride(h) + r.npos];
    const size_t n4 = 4 * static_cast<size_t>(word_node(w));
    r.nword = w;
    for (int d = 0; d < 4; ++d) {
      r.nu[d] = h.used[n4 + d];
      r.nc[d] = h.capacity[n4 + d];
    }
    r.ntp = entry_tp(h, g, w);
  }
}

// Every lane: rows with `need` set move their head on — to the next entry
// where it fits, else by a walk of the whole warp over the row's list;
// spent lists take the row out (jkey +inf).
__device__ void move_heads(const Hetero& h, bool need, int len, const float* ask, Row& r,
                           float& jkey) {
  const int lane = threadIdx.x;
  if (need && r.nword != 0 && room(r.nu, r.nc, ask)) {
    r.hword = r.nword;
    r.pos = r.npos;
    for (int d = 0; d < 4; ++d) {
      r.hu[d] = r.nu[d];
      r.hc[d] = r.nc[d];
    }
    r.htp = r.ntp;
    load_next(h, lane, len, r);
    need = false;
  }
  unsigned pending = __ballot_sync(kFull, need);
  while (pending != 0u) {
    const int g = __ffs(pending) - 1;
    pending &= pending - 1;
    const int glen = __shfl_sync(kFull, len, g);
    int base = __shfl_sync(kFull, r.nword != 0 ? r.npos + 1 : glen, g);
    float a[4];
    for (int d = 0; d < 4; ++d) a[d] = __shfl_sync(kFull, ask[d], g);
    const u64* list = h.lists + g * row_stride(h);
    int found = -1;
    u64 fw = 0;
    float fu[4];
    float fc[4];
    for (; base < glen; base += 32) {
      const int i = base + lane;
      u64 w = 0;
      float u[4];
      float c[4];
      bool ok = false;
      if (i < glen) {
        w = list[i];
        const size_t n4 = 4 * static_cast<size_t>(word_node(w));
        for (int d = 0; d < 4; ++d) {
          u[d] = h.used[n4 + d];
          c[d] = h.capacity[n4 + d];
        }
        ok = room(u, c, a);
      }
      const unsigned m = __ballot_sync(kFull, ok);
      if (m != 0u) {
        const int src = __ffs(m) - 1;
        found = base + src;
        fw = __shfl_sync(kFull, w, src);
        for (int d = 0; d < 4; ++d) {
          fu[d] = __shfl_sync(kFull, u[d], src);
          fc[d] = __shfl_sync(kFull, c[d], src);
        }
        break;
      }
    }
    if (lane == g) {
      if (found >= 0) {
        r.hword = fw;
        r.pos = found;
        for (int d = 0; d < 4; ++d) {
          r.hu[d] = fu[d];
          r.hc[d] = fc[d];
        }
        r.htp = entry_tp(h, g, fw);
        load_next(h, g, len, r);
      } else {
        r.hword = 0;
        r.pos = len;
        r.nword = 0;
        jkey = INFINITY;
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32) chain_warp_kernel(Hetero h) {
  const int lane = threadIdx.x;
  const bool real = lane < h.g;
  float ask[4];
  bool negative = false;
  for (int d = 0; d < 4; ++d) {
    ask[d] = real ? h.asks[4 * lane + d] : 0.0f;
    negative |= !(ask[d] >= 0.0f);
  }
  // usage only grows when no ask is below 0: heads only move forward
  const bool monotone = !__any_sync(kFull, negative);
  const int count = real ? h.counts[lane] : 0;
  const float tpmax = real ? h.tpmax[lane] : 0.0f;
  const int len = real ? h.len[lane] : 0;
  int placed = 0;
  float accum = 0.0f;
  float jkey = count > 0 ? job_key(h.policy, count, tpmax, 0, 0.0f) : INFINITY;
  Row r;
  r.hword = 0;
  r.pos = -1;
  r.nword = 0;
  if (real) load_next(h, lane, len, r);
  move_heads(h, count > 0, len, ask, r, jkey);  // every row's first head

  const uint32_t none = order_key(INFINITY);
  for (int step = 0; step < h.steps; ++step) {
    // the group: least job key (as its order key, one warp reduction),
    // first index
    const uint32_t key = order_key(jkey);
    const uint32_t least = __reduce_min_sync(kFull, key);
    if (least >= none) break;  // nothing placeable
    const int j = __ffs(__ballot_sync(kFull, key == least)) - 1;
    const u64 hw = __shfl_sync(kFull, r.hword, j);
    const int x = word_node(hw);
    float u[4];
    float cap[4];
    for (int d = 0; d < 4; ++d) {
      u[d] = __shfl_sync(kFull, __fadd_rn(r.hu[d], ask[d]), j);
      cap[d] = __shfl_sync(kFull, r.hc[d], j);
    }
    if (lane == j) {
      for (int d = 0; d < 4; ++d) h.used[4 * static_cast<size_t>(x) + d] = u[d];
      h.choices[static_cast<size_t>(j) * h.max_c + placed] = x;
      h.choice_tp[static_cast<size_t>(j) * h.max_c + placed] = r.htp;
      accum = __fadd_rn(accum, r.htp);
      ++placed;
      jkey = placed < count ? job_key(h.policy, count, tpmax, placed, accum) : INFINITY;
    }
    __syncwarp();
    // column x changed: the head and next entries on it take its usage;
    // heads that no longer fit move on (with a negative ask, a row it now
    // fits before its head takes it)
    const bool live = monotone ? jkey < INFINITY : real && placed < count;
    bool need = false;
    if (r.nword != 0 && word_node(r.nword) == x) {
      for (int d = 0; d < 4; ++d) r.nu[d] = u[d];
    }
    if (live && r.hword != 0 && word_node(r.hword) == x) {
      for (int d = 0; d < 4; ++d) r.hu[d] = u[d];
      need = !room(u, cap, ask);
    } else if (live && !monotone) {
      const size_t gx = static_cast<size_t>(lane) * h.n + x;
      if (h.eligible[gx] && h.tp[gx] > 0.0f && room(u, cap, ask)) {
        const u64 w = node_word(node_key(h, lane, x), x);
        if (w > r.hword) {
          const u64* list = h.lists + lane * row_stride(h);
          int lo = 0;
          int hi = len;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (list[mid] > w) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          r.hword = w;
          r.pos = lo;
          for (int d = 0; d < 4; ++d) {
            r.hu[d] = u[d];
            r.hc[d] = cap[d];
          }
          r.htp = entry_tp(h, lane, w);
          load_next(h, lane, len, r);
          jkey = job_key(h.policy, count, tpmax, placed, accum);
        }
      }
    }
    move_heads(h, need, len, ask, r, jkey);
  }
}

// Dynamic shared memory the chain may take: the card's opt-in maximum
// less its static shared memory, granted once per process by a
// thread-safe static (the launchers run with the GIL released), and
// never inside a CUDA graph capture: the first launch is an ordinary one.
struct SmemGrant {
  int error;
  size_t room;
};

const SmemGrant& smem_grant() {
  static const SmemGrant granted = [] {
    SmemGrant out{0, 0};
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, chain_kernel);
    if (e == cudaSuccess) {
      out.room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
      e = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(out.room));
    }
    out.error = static_cast<int>(e);
    return out;
  }();
  return granted;
}

struct Layout {
  size_t sorted;
  size_t lists;
  size_t len;
  size_t state;
  size_t total;
};

Layout layout(int g, int n) {
  const size_t slots = static_cast<size_t>(g) * ((n + kChunk - 1) / kChunk) * kChunk;
  Layout l;
  l.sorted = 0;
  l.lists = l.sorted + 8 * slots;
  l.len = l.lists + 8 * slots;
  l.state = (l.len + 4 * static_cast<size_t>(g) + 15) & ~static_cast<size_t>(15);
  l.total = l.state + state_bytes(g);
  return l;
}

// -- the pass under a node-axis mesh ------------------------------------------
//
// Cell (i, j) of a dp x mp mesh holds groups row i's slice of the groups
// (g0 its first) and column j's slice of the nodes (col0 its first),
// with its own copy of those nodes' usage. Its lists are the one-device
// lists of its slice, built once a call by the sort and merge launches
// above (a cell's nodes are contiguous, so its local order is the global
// order), each with a head: the first entry that fits. The global head of
// a group is the best of its cells' heads, since each cell's list is the
// global list restricted to the cell's nodes. A step:
//  - hetero_shard_step_kernel, a launch a cell, a warp a row: the row's
//    head as (order key, global node, tp's bits) while the group is short
//    of its count, else none; on a call's first step it walks every list
//    from its start first;
//  - hetero_step_merge_kernel, one block on the mesh lead over every
//    group: the best head over the columns (key desc, node asc), the
//    least job key among the placeable groups (first index), the commit
//    (slot, choice, tp, placed, accum with one f32 add) and the record
//    (the group, the node, tp's bits, the group's ask);
//  - hetero_shard_apply_kernel, one block a cell: the committed node's
//    usage grows by the ask (every cell of its column holds a copy), the
//    group's placements grow in its row, and the cell's rows whose head
//    is the node and no longer fits walk on; with a negative ask, a row
//    the node now fits before its head takes it (a binary search of its
//    list), as the one-device chain does.
// A record whose state is 1 (nothing placeable) stops the pass: every
// later launch returns at once, and the host stops queuing steps once it
// reads the lead's stop word (mesh_loop.cuh).

constexpr int kCand = 3;     // a candidate: order key, global node, tp's bits
constexpr int kRecord = 8;   // a record: state, group, node, tp's bits, ask [4]
constexpr int kPollSteps = 16;  // steps between two reads of the lead's stop word

struct CellLayout {
  size_t sorted, lists, len, hword, pos, total;
};

CellLayout cell_layout(int g, int n) {
  const size_t slots = static_cast<size_t>(g) * ((n + kChunk - 1) / kChunk) * kChunk;
  CellLayout l;
  l.sorted = 0;
  l.lists = 8 * slots;
  l.len = 16 * slots;
  l.hword = (l.len + 4 * static_cast<size_t>(g) + 15) & ~static_cast<size_t>(15);
  l.pos = l.hword + 8 * static_cast<size_t>(g);
  l.total = l.pos + 4 * static_cast<size_t>(g);
  return l;
}

// Warp: row r's head from list position `start` on, the first entry that
// fits (0 when the list is spent).
__device__ void cell_walk(const Hetero& h, u64* hword, int32_t* pos, int r, int start) {
  const int lane = threadIdx.x & 31;
  const int len = h.len[r];
  const u64* list = h.lists + r * row_stride(h);
  const float* a = h.asks + 4 * static_cast<size_t>(r);
  for (int base = start; base < len; base += 32) {
    const int i = base + lane;
    u64 w = 0;
    bool ok = false;
    if (i < len) {
      w = list[i];
      const size_t n4 = 4 * static_cast<size_t>(word_node(w));
      ok = room(h.used + n4, h.capacity + n4, a);
    }
    const unsigned m = __ballot_sync(kFull, ok);
    if (m != 0u) {
      const int src = __ffs(m) - 1;
      const u64 hw = __shfl_sync(kFull, w, src);
      if (lane == 0) {
        pos[r] = base + src;
        hword[r] = hw;
      }
      return;
    }
  }
  if (lane == 0) {
    pos[r] = len;
    hword[r] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    hetero_shard_step_kernel(Hetero h, u64* hword, int32_t* pos, const int32_t* placed,
                             const int32_t* record, int col0, int first_step, int32_t* cand) {
  if (record != nullptr && record[0] != 0) return;
  const int lane = threadIdx.x & 31;
  const int r = static_cast<int>(blockIdx.x) * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (r >= h.g) return;
  if (first_step) cell_walk(h, hword, pos, r, 0);
  if (lane != 0) return;
  const u64 w = hword[r];
  int32_t* c = cand + kCand * static_cast<size_t>(r);
  if (w != 0 && placed[r] < h.counts[r]) {
    const int x = word_node(w);
    c[0] = static_cast<int32_t>(w >> 32);
    c[1] = col0 + x;
    c[2] = __float_as_int(h.tp[static_cast<size_t>(r) * h.n + x]);
  } else {
    c[0] = 0;
    c[1] = -1;
    c[2] = 0;
  }
}

// The best head of group j over the `cells` columns' candidates
// [cells, g, kCand] (key desc, node asc); -1 when none holds one.
__device__ int best_column(const int32_t* cand, int cells, int g, int j) {
  int bc = -1;
  u64 br = 0;
  for (int c = 0; c < cells; ++c) {
    const int32_t* e = cand + kCand * (static_cast<size_t>(c) * g + j);
    const uint32_t key = static_cast<uint32_t>(e[0]);
    if (key == 0u) continue;
    const u64 rank = (static_cast<u64>(key) << 32) | (kFull - static_cast<uint32_t>(e[1]));
    if (rank > br) {
      br = rank;
      bc = c;
    }
  }
  return bc;
}

__global__ void __launch_bounds__(kThreads)
    hetero_step_merge_kernel(const int32_t* cand, int cells, int g, int policy, int max_c,
                             const int32_t* counts, const float* tpmax, const float* asks,
                             int32_t* placed, float* accum, int32_t* choices, float* choice_tp,
                             int32_t* record) {
  __shared__ u64 s_least[kWarps];
  if (record[0] != 0) return;  // the pass stopped: every later step is the same no-op
  const uint32_t none = order_key(INFINITY);
  // (order_key(job key) << 32 | group) of the thread's least placeable group
  u64 mine = ~0ull;
  for (int j = threadIdx.x; j < g; j += kThreads) {
    const int p = placed[j];
    if (p >= counts[j] || best_column(cand, cells, g, j) < 0) continue;
    const uint32_t k = order_key(job_key(policy, counts[j], tpmax[j], p, accum[j]));
    if (k >= none) continue;
    const u64 w = (static_cast<u64>(k) << 32) | static_cast<uint32_t>(j);
    mine = w < mine ? w : mine;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, mine, off);
    mine = o < mine ? o : mine;
  }
  if ((threadIdx.x & 31) == 0) s_least[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x != 0) return;
  u64 least = ~0ull;
  for (int w = 0; w < kWarps; ++w) least = s_least[w] < least ? s_least[w] : least;
  if (least == ~0ull) {  // nothing placeable
    record[0] = 1;
    return;
  }
  const int j = static_cast<int>(static_cast<uint32_t>(least));
  const int32_t* e = cand + kCand * (static_cast<size_t>(best_column(cand, cells, g, j)) * g + j);
  const int slot = placed[j];
  const float t = __int_as_float(e[2]);
  choices[static_cast<size_t>(j) * max_c + slot] = e[1];
  choice_tp[static_cast<size_t>(j) * max_c + slot] = t;
  placed[j] = slot + 1;
  accum[j] = __fadd_rn(accum[j], t);
  record[1] = j;
  record[2] = e[1];
  record[3] = e[2];
  for (int d = 0; d < 4; ++d) record[4 + d] = __float_as_int(asks[4 * static_cast<size_t>(j) + d]);
}

// One block a cell. Without lists (`hword` null) only the usage and the
// placements move.
__global__ void __launch_bounds__(kThreads)
    hetero_shard_apply_kernel(Hetero h, u64* hword, int32_t* pos, int32_t* placed,
                              const int32_t* record, int col0, int g0) {
  __shared__ float s_u[4];
  if (record[0] != 0) return;
  const int j = record[1] - g0;
  const int x = record[2] - col0;
  const bool inside = x >= 0 && x < h.n;
  if (threadIdx.x == 0 && j >= 0 && j < h.g) placed[j] += 1;
  if (inside && threadIdx.x < 4) {
    float* u = h.used + 4 * static_cast<size_t>(x) + threadIdx.x;
    const float nu = __fadd_rn(*u, __int_as_float(record[4 + threadIdx.x]));
    *u = nu;
    s_u[threadIdx.x] = nu;
  }
  __syncthreads();
  if (!inside || hword == nullptr) return;
  const int lane = threadIdx.x & 31;
  float u[4];
  float cap[4];
  for (int d = 0; d < 4; ++d) {
    u[d] = s_u[d];
    cap[d] = h.capacity[4 * static_cast<size_t>(x) + d];
  }
  for (int r = threadIdx.x >> 5; r < h.g; r += kWarps) {
    if (placed[r] >= h.counts[r]) continue;
    const u64 hw = hword[r];
    const float* a = h.asks + 4 * static_cast<size_t>(r);
    if (hw != 0 && word_node(hw) == x) {
      if (!room(u, cap, a)) cell_walk(h, hword, pos, r, pos[r] + 1);
      continue;
    }
    const size_t rx = static_cast<size_t>(r) * h.n + x;
    if (lane != 0 || !h.eligible[rx] || !(h.tp[rx] > 0.0f) || !room(u, cap, a)) continue;
    const u64 w = node_word(node_key(h, r, x), x);
    if (w <= hw) continue;
    const u64* list = h.lists + r * row_stride(h);
    int lo = 0;
    int hi = h.len[r];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] > w) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    pos[r] = lo;
    hword[r] = w;
  }
}

// A cell's Hetero over its parts, its lists in `scratch` (cell_layout).
Hetero cell_hetero(const float* capacity, const float* asks, const int32_t* counts,
                   const uint8_t* eligible, const float* tp, const float* cost, float* used,
                   int policy, int g, int n, unsigned char* scratch) {
  const CellLayout l = cell_layout(g, n);
  Hetero h{capacity, asks, counts, eligible, tp, nullptr, cost, policy, g, n, 0, 0,
           (n + kChunk - 1) / kChunk,
           scratch == nullptr ? nullptr : reinterpret_cast<u64*>(scratch + l.sorted),
           scratch == nullptr ? nullptr : reinterpret_cast<u64*>(scratch + l.lists),
           scratch == nullptr ? nullptr : reinterpret_cast<int32_t*>(scratch + l.len),
           nullptr, nullptr, nullptr, used};
  return h;
}

u64* cell_hword(unsigned char* scratch, int g, int n) {
  return reinterpret_cast<u64*>(scratch + cell_layout(g, n).hword);
}

int32_t* cell_pos(unsigned char* scratch, int g, int n) {
  return reinterpret_cast<int32_t*>(scratch + cell_layout(g, n).pos);
}

// The launch just made: its error, and one more in `launched` (when
// given) if it was accepted.
cudaError_t launched_ok(long long* launched) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && launched != nullptr) ++*launched;
  return e;
}

// The cell's lists: the sort and merge launches of the one-device pass.
cudaError_t build_lists(const Hetero& h, cudaStream_t st, long long* launched) {
  const unsigned blocks = static_cast<unsigned>(h.g) * static_cast<unsigned>(h.chunks);
  sort_kernel<<<blocks, kThreads, 0, st>>>(h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_kernel<<<blocks, kThreads, 0, st>>>(h);
  return launched_ok(launched);
}

cudaError_t launch_step(const Hetero& h, unsigned char* scratch, const int32_t* placed,
                        const int32_t* record, int col0, int first_step, int32_t* cand,
                        cudaStream_t st, long long* launched) {
  const unsigned blocks = static_cast<unsigned>((h.g + kWarps - 1) / kWarps);
  hetero_shard_step_kernel<<<blocks, kThreads, 0, st>>>(
      h, cell_hword(scratch, h.g, h.n), cell_pos(scratch, h.g, h.n), placed, record, col0,
      first_step, cand);
  return launched_ok(launched);
}

// The per-cell pointers the step loop takes, in this order.
enum HeteroPtr {
  kHCapacity, kHAsks, kHCounts, kHEligible, kHTp, kHCost,
  kHUsed,         // f32 [n, 4]: the cell's copy of its nodes' usage, used0 at the start
  kHPlaced,       // i32 [g]: placements of the cell's groups, zero at the start
  kHScratch,      // cell_layout(g, n) bytes: the lists and their heads
  kHCand,         // i32 [g, kCand]: the cell's candidates
  kHRecord,       // i32 [kRecord]: the step's record as the cell received it, zero at the start
  kHGathered,     // the lead only: i32 [mp, G, kCand]
  kHLeadPlaced,   // the lead only: i32 [G], zero at the start
  kHAccum,        // the lead only: f32 [G], zero at the start
  kHEveryCounts,  // the lead only: i32 [G]
  kHEveryTpmax,   // the lead only: f32 [G]
  kHEveryAsks,    // the lead only: f32 [G, 4]
  kHChoices,      // the lead only: i32 [G, C], -1 at the start
  kHChoiceTp,     // the lead only: f32 [G, C], 0 at the start
  kHMaster,       // the lead only: i32 [kRecord], zero at the start
  kHHomeStream,   // the stream the cell's tensors were made on
  kHCellPtrs
};

// The entries of the step loop's launch counts.
enum HLaunched { kHLaunchedStep, kHLaunchedMerge, kHLaunchedApply, kHLaunchedBuild };

// The sharded pass of one call: `rows` groups rows of `mp` cells each
// (cell (i, j) is index i * mp + j, cell 0 the mesh lead), `gseg` groups
// a row over `seg` nodes a cell (mesh_loop.cuh runs the steps). Launches:
// a list build a cell a call, then per step a shard step and an apply a
// cell and one merge. `launched` [4] gains the shard steps, merges,
// applies and list builds, counted where each launches.
int hetero_sharded(int rows, int mp, const int* devices, void* const* ptrs, int gseg, int seg,
                   int policy, int steps, int max_c, int32_t* poll, long long* launched) {
  const int cells = rows * mp;
  const int g = rows * gseg;
  const auto P = [&](int cell, int k) { return ptrs[static_cast<size_t>(cell) * kHCellPtrs + k]; };
  std::vector<void*> home(cells);
  for (int c = 0; c < cells; ++c) home[c] = P(c, kHHomeStream);
  MeshLoop loop(cells, devices, home);
  const auto cell = [&](int c) {
    return cell_hetero(static_cast<const float*>(P(c, kHCapacity)),
                       static_cast<const float*>(P(c, kHAsks)),
                       static_cast<const int32_t*>(P(c, kHCounts)),
                       static_cast<const uint8_t*>(P(c, kHEligible)),
                       static_cast<const float*>(P(c, kHTp)),
                       static_cast<const float*>(P(c, kHCost)),
                       static_cast<float*>(P(c, kHUsed)), policy, gseg, seg,
                       static_cast<unsigned char*>(P(c, kHScratch)));
  };
  const auto scratch = [&](int c) { return static_cast<unsigned char*>(P(c, kHScratch)); };
  loop.each([&](int c, cudaStream_t st) {
    return build_lists(cell(c), st, launched + kHLaunchedBuild);
  });
  for (int step = 0; step < steps && loop.go_on(step, kPollSteps, poll, P(0, kHMaster)); ++step) {
    loop.step(
        [&](int c, cudaStream_t st) {
          return launch_step(cell(c), scratch(c), static_cast<const int32_t*>(P(c, kHPlaced)),
                             static_cast<const int32_t*>(P(c, kHRecord)), c % mp * seg, step == 0,
                             static_cast<int32_t*>(P(c, kHCand)), st, launched + kHLaunchedStep);
        },
        static_cast<size_t>(gseg) * kCand * 4, [&](int c) { return P(c, kHCand); },
        [&](int c) {
          // column j's candidates for groups [i gseg, (i + 1) gseg) of [mp, G]
          return static_cast<char*>(P(0, kHGathered)) +
                 (static_cast<size_t>(c % mp) * g + static_cast<size_t>(c / mp) * gseg) * kCand *
                     4;
        },
        [&](cudaStream_t st) {
          hetero_step_merge_kernel<<<1, kThreads, 0, st>>>(
              static_cast<const int32_t*>(P(0, kHGathered)), mp, g, policy, max_c,
              static_cast<const int32_t*>(P(0, kHEveryCounts)),
              static_cast<const float*>(P(0, kHEveryTpmax)),
              static_cast<const float*>(P(0, kHEveryAsks)),
              static_cast<int32_t*>(P(0, kHLeadPlaced)), static_cast<float*>(P(0, kHAccum)),
              static_cast<int32_t*>(P(0, kHChoices)), static_cast<float*>(P(0, kHChoiceTp)),
              static_cast<int32_t*>(P(0, kHMaster)));
          return launched_ok(launched + kHLaunchedMerge);
        },
        P(0, kHMaster), kRecord * 4, [&](int c) { return P(c, kHRecord); },
        [&](int c, cudaStream_t st) {
          hetero_shard_apply_kernel<<<1, kThreads, 0, st>>>(
              cell(c), cell_hword(scratch(c), gseg, seg), cell_pos(scratch(c), gseg, seg),
              static_cast<int32_t*>(P(c, kHPlaced)), static_cast<const int32_t*>(P(c, kHRecord)),
              c % mp * seg, c / mp * gseg);
          return launched_ok(launched + kHLaunchedApply);
        });
  }
  return loop.finish();
}

}  // namespace

// C entry point, bound with ctypes (nomad_tpu_torch/scheduler/hetero.py).
// Launches the pass's three kernels on `stream`, allocates nothing, and
// returns the first launch error (cudaGetLastError()) so a refused launch
// is reported to the caller. `used` holds used0 on entry (the pass
// updates it in place); `choices` and `choice_tp` hold -1 and 0;
// `scratch` holds `scratch_bytes` bytes, at least hetero_scratch_bytes(g,
// n) of the wrapper: the sorted chunks and the lists (8 bytes a (group,
// node) slot each, nodes rounded up to 2,048), the list lengths and the
// chain's state for when it does not fit in shared memory.
extern "C" int nomad_hetero_place(
    const float* capacity, const float* asks, const int32_t* counts,
    const uint8_t* eligible, const float* tp, const float* tpmax,
    const float* cost, int policy, int g, int n, int steps, int max_c,
    unsigned char* scratch, size_t scratch_bytes, int32_t* choices,
    float* choice_tp, float* used, void* stream) {
  if (g < 1 || n < 1 || max_c < 1 || policy < kMaxmin || policy > kCost) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (n + kChunk - 1) / kChunk;
  const Layout l = layout(g, n);
  if (static_cast<long long>(g) * chunks > INT_MAX || scratch_bytes < l.total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SmemGrant& granted = smem_grant();
  if (granted.error != 0) return granted.error;
  Hetero h{capacity, asks, counts, eligible, tp, tpmax, cost, policy, g, n,
           steps, max_c, chunks,
           reinterpret_cast<u64*>(scratch + l.sorted),
           reinterpret_cast<u64*>(scratch + l.lists),
           reinterpret_cast<int32_t*>(scratch + l.len), scratch + l.state,
           choices, choice_tp, used};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(g) * static_cast<unsigned>(chunks);
  sort_kernel<<<blocks, kThreads, 0, st>>>(h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<blocks, kThreads, 0, st>>>(h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g <= 32) {
    chain_warp_kernel<<<1, 32, 0, st>>>(h);
  } else {
    const size_t bytes = state_bytes(g);
    const int in_smem = bytes <= granted.room ? 1 : 0;
    chain_kernel<<<1, kThreads, in_smem ? bytes : 0, st>>>(h, in_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- the mesh kernels' entry points (nomad_tpu_torch/scheduler/hetero.py) --

// Bytes of a cell's scratch: its lists and their heads.
extern "C" int nomad_hetero_cell_scratch_bytes(int g, int n, size_t* bytes) {
  *bytes = cell_layout(g, n).total;
  return 0;
}

// One cell's candidates (a step loop's first step): the cell's lists
// built in `scratch`, every head walked, the candidates written.
extern "C" int nomad_hetero_shard_step(
    const float* capacity, const float* used, const float* asks, const int32_t* counts,
    const uint8_t* eligible, const float* tp, const float* cost, const int32_t* placed,
    int policy, int g, int n, int col0, unsigned char* scratch, size_t scratch_bytes,
    int32_t* cand, void* stream) {
  if (g < 1 || n < 1 || policy < kMaxmin || policy > kCost ||
      scratch_bytes < cell_layout(g, n).total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hetero h = cell_hetero(capacity, asks, counts, eligible, tp, cost,
                               const_cast<float*>(used), policy, g, n, scratch);
  const cudaError_t e = build_lists(h, st, nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_step(h, scratch, placed, nullptr, col0, 1, cand, st, nullptr));
}

// One step's merge on the mesh lead over `cells` columns of `g` groups'
// candidates; `record` zero on entry.
extern "C" int nomad_hetero_step_merge(
    const int32_t* cand, int cells, int g, int policy, int max_c, const int32_t* counts,
    const float* tpmax, const float* asks, int32_t* placed, float* accum, int32_t* choices,
    float* choice_tp, int32_t* record, void* stream) {
  if (cells < 1 || g < 1 || max_c < 1 || policy < kMaxmin || policy > kCost) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  hetero_step_merge_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cand, cells, g, policy, max_c, counts, tpmax, asks, placed, accum, choices, choice_tp,
      record);
  return static_cast<int>(cudaGetLastError());
}

// One cell's usage and placements after a step (no lists: only those move).
extern "C" int nomad_hetero_shard_apply(const int32_t* record, float* used, int32_t* placed,
                                        int n, int g, int col0, int g0, void* stream) {
  if (n < 1 || g < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hetero h = cell_hetero(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, used,
                               kMaxmin, g, n, nullptr);
  hetero_shard_apply_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, nullptr, nullptr, placed, record, col0, g0);
  return static_cast<int>(cudaGetLastError());
}

// The step loop: `ptrs` holds kHCellPtrs pointers a cell (HeteroPtr
// order), `devices` each cell's device, `poll` one pinned int32,
// `launched` i64[4] added to; see hetero_sharded.
extern "C" int nomad_sharded_hetero(int rows, int mp, const int* devices, void* const* ptrs,
                                    int gseg, int seg, int policy, int steps, int max_c,
                                    int32_t* poll, long long* launched) {
  if (rows < 1 || mp < 1 || gseg < 1 || seg < 1 || max_c < 1 || policy < kMaxmin ||
      policy > kCost || static_cast<long long>(gseg) * ((seg + kChunk - 1) / kChunk) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      hetero_sharded(rows, mp, devices, ptrs, gseg, seg, policy, steps, max_c, poll, launched));
}

// The per-cell pointer count the step loop reads.
extern "C" int nomad_hetero_cell_ptrs() { return kHCellPtrs; }
