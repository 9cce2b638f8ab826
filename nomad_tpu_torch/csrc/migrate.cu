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
// What bounds it on the H100: the chain of rounds, and in each round the
// rows' searches. The function's own bytes (the grid read once, 5 bytes a
// cell: 1 GB at 20,000 allocs x 10,000 nodes) take 0.3 ms; the reference
// computes it by pricing every cell of the grid every round.
//
// Design: two launches of 512-thread blocks, in three parts.
//  1. Lists, a block a row, in their own launch. base[a, n] = (score - cur_score) - move_cost
//     never changes within a pass, and gain = base - lam[n] is monotone in
//     both. Each row keeps its first K = 1,024 candidates (eligible, not
//     its current node) in (base desc, node asc) order, as (node, base)
//     pairs: the K-th largest base T by radix select over 11/11/10-bit
//     digits of its order key, the nodes above T and the lowest-indexed
//     nodes at T, sorted (bitonic: strides to 32 words in registers and
//     warp shuffles, longer ones in shared memory). One pass reads the
//     row from the grid; up to N 16,384 its keys stay in shared memory
//     for the select's other passes (beyond, they are read again). Beside
//     the list: its last base (the tail), the largest base below the tail
//     (next), and the first entry left out.
//  2. Rounds, one cooperative launch of as many blocks as are resident,
//     two grid barriers a round (three when a row scans densely):
//     - walk: a warp a row reads its list 32 entries at a time (8 bytes
//       an entry, coalesced) and each entry's price (from shared memory
//       where each block stages the round's prices: up to N 16,384, and
//       where rows are many enough that their gathers outweigh the
//       staging), and gathers usage and capacity only where the entry
//       could beat the best so far. Rounded subtraction is monotone, so no entry after e
//       gains more than bound(e) = base(e) - lam_min, lam_min the round's
//       least price (NaN excluded). The walk stops after a chunk whose
//       last entry e has bound(e) < best (or <= 0 with no best yet), or
//       bound(e) == best, e's node above best's, and (the float below
//       base(e)) - lam_min < best, or e in the tail run and next -
//       lam_min < best: every later entry of e's base has a larger node
//       and cannot win the tie, every lower base gains less than best.
//       Past the list's end the same two tests run on the
//       first entry left out; a row they do not settle scans densely from
//       then on. Entries at the head of the list that do not fit stay
//       unfit (usage only grows: every size is >= 0, checked once) and
//       are skipped in later rounds. The claim is exactly the dense
//       first-index argmax. It goes to its node as claims += 1 and a
//       64-bit max of (gain bits << 32 | 0xFFFFFFFF - a); the first claim
//       on a node counts it in its block's slice of the nodes;
//     - dense rows, when any: (row group, node tile) items over every
//       block, the tile's usage, price and capacity staged in shared
//       memory, 16-byte score and 4-byte eligibility loads, streaming
//       (__ldcs) so that node state keeps its place in L2. A row's tiles
//       merge by a 64-bit max of (gain bits << 32 | ~node) (a claimed
//       gain is > 0, so its bits order as the floats do); the last tile
//       to finish posts the row's claim;
//     - node pass on every block, each over its slice of the nodes: the
//       slice counts posted in the walk give each block its offset among
//       the claimed nodes (a two-level prefix); an admitted node's winner
//       commits; usage, price and the claim words update on every node;
//       the block's least new price goes to next round's lam_min by an
//       integer max on inverted order keys (no float atomics).
//       Moves, rounds and progress follow from the claimed count alone,
//       which every block reads the same, so all leave the loop together.
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
constexpr int kList = 1024;           // candidates kept a row
constexpr int kBins = 2048;           // 11-bit radix digits
constexpr int kTile = 1024;           // nodes of a dense tile, at most
constexpr int kTileRows = 2 * kWarps;  // rows of a dense item
constexpr int kMaxGrid = 2048;        // blocks, at most (slice counts a round)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEta = 0.125f;
constexpr int kDense = 1;             // row flag: scans densely from now on
constexpr int kStageMax = 16384;      // keys, and prices, staged in shared memory up to this N
static_assert(kList == 2 * kThreads, "the sort holds two list words a thread");

struct Mig {
  const float4* capacity;     // [N]
  const float4* sizes;        // [A]
  const int32_t* cur;         // [A]
  const uint8_t* eligible;    // [A, N]
  const float* scores;        // [A, N]
  const float* cur_scores;    // [A]
  const float* move_cost;     // [A]
  int a, n, budget, steps, list_len;
  bool vec;                   // 16-byte score / 4-byte eligibility loads
  bool stage_lam;             // the rounds stage every price in shared memory
  unsigned* barrier;          // [2]: arrivals, generation
  int32_t* queue_len;         // [1]: rows queued for a dense scan
  int32_t* negative;          // [1]: a size component below 0
  unsigned* lam_min;          // [2]: inverted order key of the least price
  unsigned long long* key;    // [N]: the round's best claim, 0 = none
  int32_t* claims;            // [N]
  int32_t* slices;            // [2, kMaxGrid]: claimed nodes a slice
  int32_t* queue;             // [A]
  unsigned long long* row_word;  // [A]: a dense row's best (gain, node)
  int32_t* row_done;          // [A]: its tiles done
  int32_t* start;             // [A]: first list entry that may still fit
  int32_t* len;               // [A]
  int32_t* flags;             // [A]
  unsigned* tail;             // [A]: order key of the list's last base
  unsigned* next;             // [A]: largest key below the tail, 0 = none
  unsigned* first_out;        // [A]: key of the first entry left out, 0 = none
  int32_t* first_out_node;    // [A]
  int2* lists;                // [A, list_len]: (node, base bits)
  float4* used;               // [N], used0 on entry
  float* lam;                 // [N], lam0 on entry
  int32_t* dest;              // [A], -1 on entry
  float* gains;               // [A], 0 on entry
  int32_t* moves;             // [1], 0 on entry
  int32_t* rounds;            // [1], 0 on entry
};

struct Layout {
  long long key, claims, slices, queue, row_word, row_done, start, len, flags,
      tail, next, first_out, first_out_node, lists, total;
};

constexpr long long kHeader = 32;  // barrier, queue length, negative, lam_min

Layout layout(int a, int n, int list_len) {
  Layout l{};
  long long at = kHeader;
  auto take = [&at](long long words) {
    const long long s = at;
    at += (words + 31) / 32 * 32;
    return s;
  };
  l.key = take(2LL * n);
  l.claims = take(n);
  l.slices = take(2LL * kMaxGrid);
  l.queue = take(a);
  l.row_word = take(2LL * a);
  l.row_done = take(a);
  l.start = take(a);
  l.len = take(a);
  l.flags = take(a);
  l.tail = take(a);
  l.next = take(a);
  l.first_out = take(a);
  l.first_out_node = take(a);
  l.lists = take(2LL * a * list_len);
  l.total = at;
  return l;
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

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
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

// The least price as read back: the inverted order key, 0 when every
// price is NaN (then no gain is > 0, and +inf stops every walk at once).
__device__ __forceinline__ float lam_min_value(unsigned inv) {
  return inv == 0u ? INFINITY : key_value(~inv);
}

__device__ __forceinline__ int slice_len(const Mig& c) {
  return (c.n + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
}

// A row's claim on `node` with gain bits `gbits`.
__device__ void post_claim(const Mig& c, int node, unsigned gbits, int a, int par) {
  if (atomicAdd(c.claims + node, 1) == 0) {
    atomicAdd(c.slices + par * kMaxGrid + node / slice_len(c), 1);
  }
  atomicMax(c.key + node, (static_cast<unsigned long long>(gbits) << 32) |
                              (kFull - static_cast<unsigned>(a)));
}

// -- part 1: the lists ------------------------------------------------------

struct BuildShared {
  uint32_t hist[kBins];
  unsigned long long words[kList];
  uint32_t warp_count[kWarps];
  uint32_t count, fill, digit, left, next, first_out_node;
};

// Scanning bins from the top, the bin holding the rem-th largest key;
// leaves the bin in s.digit and rem minus the count above it in s.left.
__device__ void select_digit(BuildShared& s, int nbins, uint32_t rem) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = nbins / 32;
    const int hi = nbins - lane * per;  // lane 0 owns the top bins
    uint32_t sum = 0;
    for (int b = hi - 1; b >= hi - per; --b) sum += s.hist[b];
    uint32_t incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const uint32_t excl = incl - sum;
    const unsigned hit = __ballot_sync(kFull, excl < rem && rem <= incl);
    if (lane == __ffs(hit) - 1) {
      uint32_t cum = excl;
      for (int b = hi - 1; b >= hi - per; --b) {
        if (cum + s.hist[b] >= rem) {
          s.digit = static_cast<uint32_t>(b);
          s.left = rem - cum;
          break;
        }
        cum += s.hist[b];
      }
    }
  }
  __syncthreads();
}

// Sorts s.words ascending (bitonic over kList = 2 words a thread): the
// stages of stride 32 words or less in registers and warp shuffles, the
// longer ones through shared memory.
__device__ void sort_words(BuildShared& s) {
  const int tid = threadIdx.x;
  unsigned long long w[2] = {s.words[2 * tid], s.words[2 * tid + 1]};
  for (int size = 2; size <= kList; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 64) {  // the partner is in another warp
        __syncthreads();
        s.words[2 * tid] = w[0];
        s.words[2 * tid + 1] = w[1];
        __syncthreads();
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = 2 * tid + b;
        unsigned long long o;
        if (stride == 1) {
          o = w[b ^ 1];
        } else if (stride < 64) {
          o = __shfl_xor_sync(kFull, w[b], stride >> 1);
        } else {
          o = s.words[i ^ stride];
        }
        const bool keep_min = ((i & stride) == 0) == ((i & size) == 0);
        const unsigned long long lo = o < w[b] ? o : w[b];
        const unsigned long long hi = o < w[b] ? w[b] : o;
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
  __syncthreads();
  s.words[2 * tid] = w[0];
  s.words[2 * tid + 1] = w[1];
  __syncthreads();
}

struct RowRef {
  const float* scores;
  const uint8_t* eligible;
  int cur;
  float cur_score, cost;
};

__device__ __forceinline__ RowRef row_ref(const Mig& c, int a) {
  const size_t at = static_cast<size_t>(a) * c.n;
  return RowRef{c.scores + at, c.eligible + at, c.cur[a], c.cur_scores[a], c.move_cost[a]};
}

__device__ __forceinline__ float base_of(const RowRef& r, int n) {
  return __fsub_rn(__fsub_rn(r.scores[n], r.cur_score), r.cost);
}

// The candidate key of node n of row r, 0 for a node that is not a
// candidate (every real key is above 0: order_key(-inf) = 0x007FFFFF).
__device__ __forceinline__ uint32_t cand_key(const RowRef& r, int n, float score, bool elig) {
  return elig && n != r.cur
             ? order_key(__fsub_rn(__fsub_rn(score, r.cur_score), r.cost))
             : 0u;
}

// Adds one to bin `bin` for every lane where `valid`, one shared atomic
// per distinct bin of the warp (keys crowd into few bins: scores on a
// coarse grid, many equal bases). Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin, bool valid) {
  const unsigned lanes = __ballot_sync(kFull, valid);
  if (__popc(lanes) <= 4) {  // few keys: their atomics collide little
    if (valid) atomicAdd(&hist[bin], 1u);
    return;
  }
  const unsigned peers = __match_any_sync(kFull, valid ? bin : kFull);
  if (valid && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
  }
}

// The row's candidate keys, computed from the grid in one pass (16-byte
// score and 4-byte eligibility loads where aligned) into `keys` (shared
// memory) when it is given, with the histogram of their top 11 bits and
// their count.
__device__ void first_pass(const Mig& c, const RowRef& r, BuildShared& s, uint32_t* keys) {
  for (int b = threadIdx.x; b < kBins; b += kThreads) s.hist[b] = 0;
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  uint32_t counted = 0;
  const auto add = [&](int n, uint32_t key, bool in) {
    if (in && keys != nullptr) keys[n] = key;
    counted += key != 0u;
    hist_add(s.hist, key >> 21, key != 0u);
  };
  if (c.vec) {
    // each step's loads issued a step ahead
    const auto load = [&](int j, float4* sc, unsigned* el) {
      *sc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *el = 0;
      if (j < c.n) {
        *sc = *reinterpret_cast<const float4*>(r.scores + j);
        *el = *reinterpret_cast<const unsigned*>(r.eligible + j);
      }
    };
    float4 next_sc;
    unsigned next_el;
    load(4 * static_cast<int>(threadIdx.x), &next_sc, &next_el);
    for (int j0 = 0; j0 < c.n; j0 += 4 * kThreads) {
      const int j = j0 + 4 * static_cast<int>(threadIdx.x);
      const bool in = j < c.n;
      const float4 sc = next_sc;
      const unsigned el = next_el;
      load(j + 4 * kThreads, &next_sc, &next_el);
      add(j, cand_key(r, j, sc.x, (el & 0xffu) != 0), in);
      add(j + 1, cand_key(r, j + 1, sc.y, (el & 0xff00u) != 0), in);
      add(j + 2, cand_key(r, j + 2, sc.z, (el & 0xff0000u) != 0), in);
      add(j + 3, cand_key(r, j + 3, sc.w, (el & 0xff000000u) != 0), in);
    }
  } else {
    for (int n0 = 0; n0 < c.n; n0 += kThreads) {
      const int n = n0 + static_cast<int>(threadIdx.x);
      const bool in = n < c.n;
      add(n, in ? cand_key(r, n, r.scores[n], r.eligible[n] != 0) : 0u, in);
    }
  }
  counted = __reduce_add_sync(kFull, counted);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s.count, counted);
  __syncthreads();
}

// Histogram of the `width` bits at `shift` of the row's candidate keys
// whose bits above `shift + width` equal `prefix`: from `keys` when the
// first pass staged them, else from the grid again.
__device__ void row_histogram(const Mig& c, const RowRef& r, BuildShared& s,
                              const uint32_t* keys, int width, int shift,
                              uint32_t prefix) {
  const int nbins = 1 << width;
  const int high = shift + width;
  for (int b = threadIdx.x; b < nbins; b += kThreads) s.hist[b] = 0;
  __syncthreads();
  for (int n0 = 0; n0 < c.n; n0 += kThreads) {
    const int n = n0 + static_cast<int>(threadIdx.x);
    uint32_t key = 0;
    if (n < c.n) {
      key = keys != nullptr ? keys[n] : cand_key(r, n, r.scores[n], r.eligible[n] != 0);
    }
    hist_add(s.hist, (key >> shift) & static_cast<uint32_t>(nbins - 1),
             key != 0u && (key >> high) == prefix);
  }
  __syncthreads();
}

__device__ void build_row(const Mig& c, BuildShared& s, uint32_t* keys, int a) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const RowRef r = row_ref(c, a);
  const int k = c.list_len;
  first_pass(c, r, s, keys);
  const uint32_t count = s.count;
  const bool truncated = count > static_cast<uint32_t>(k);
  uint32_t t = 0, take_eq = 0, eq_total = 0;
  if (truncated) {
    select_digit(s, kBins, k);
    const uint32_t d1 = s.digit;
    row_histogram(c, r, s, keys, 11, 10, d1);
    select_digit(s, kBins, s.left);
    const uint32_t d12 = (d1 << 11) | s.digit;
    row_histogram(c, r, s, keys, 10, 0, d12);
    select_digit(s, kBins / 2, s.left);
    t = (d12 << 10) | s.digit;
    take_eq = s.left;
    eq_total = s.hist[s.digit];
  }
  if (tid == 0) {
    s.fill = 0;
    s.next = 0;
    s.first_out_node = kFull;
  }
  __syncthreads();
  // keys above T all go in; keys at T by ascending node, the first
  // take_eq of them: a block-wide rank in node order, each thread over 4
  // consecutive nodes of a chunk
  uint32_t carried = 0;
  for (int base = 0; base < c.n; base += 4 * kThreads) {
    const int n0 = base + 4 * tid;
    uint32_t key[4];
    uint32_t mine = 0;  // keys at T among this thread's nodes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + i;
      key[i] = 0;
      if (n < c.n) {
        key[i] = keys != nullptr ? keys[n] : cand_key(r, n, r.scores[n], r.eligible[n] != 0);
      }
      mine += truncated && key[i] != 0u && key[i] == t;
    }
    uint32_t incl = mine;  // inclusive scan over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s.warp_count[warp] = incl;
    __syncthreads();
    uint32_t below = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      below += w < warp ? s.warp_count[w] : 0;
      total += s.warp_count[w];
    }
    __syncthreads();  // warp_count is rewritten by the next chunk
    uint32_t rank = carried + below + incl - mine;
    uint32_t below_t = 0;  // the largest key under T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool cand = key[i] != 0u;
      const bool eq = truncated && cand && key[i] == t;
      const bool take = cand && (!truncated || key[i] > t || (eq && rank < take_eq));
      if (eq && rank == take_eq) s.first_out_node = static_cast<uint32_t>(n0 + i);
      if (truncated && cand && key[i] < t) below_t = max(below_t, key[i]);
      rank += eq;
      const unsigned took = __ballot_sync(kFull, take);
      uint32_t slot = 0;
      if (lane == 0 && took != 0u) slot = atomicAdd(&s.fill, static_cast<uint32_t>(__popc(took)));
      slot = __shfl_sync(kFull, slot, 0) + __popc(took & ((1u << lane) - 1u));
      if (take) {
        s.words[slot] = (static_cast<unsigned long long>(~key[i]) << 32) |
                        static_cast<unsigned>(n0 + i);
      }
    }
    below_t = __reduce_max_sync(kFull, below_t);
    if (lane == 0 && below_t != 0u) atomicMax(&s.next, below_t);
    carried += total;
  }
  __syncthreads();
  const int fill = static_cast<int>(s.fill);
  for (int i = fill + tid; i < kList; i += kThreads) s.words[i] = ~0ULL;
  __syncthreads();
  sort_words(s);
  int2* list = c.lists + static_cast<size_t>(a) * k;
  for (int i = tid; i < fill; i += kThreads) {
    const int n = static_cast<int>(s.words[i] & 0xffffffffu);
    __stcg(list + i, make_int2(n, __float_as_int(base_of(r, n))));
  }
  if (tid == 0) {
    __stcg(c.len + a, fill);
    __stcg(c.start + a, 0);
    __stcg(c.flags + a, 0);
    const uint32_t last = fill > 0 ? ~static_cast<uint32_t>(s.words[fill - 1] >> 32) : 0u;
    __stcg(c.tail + a, truncated ? t : last);
    __stcg(c.next + a, truncated ? s.next : 0u);
    // the first entry left out: a key at T when some stayed out, else the
    // largest below T
    const bool t_out = truncated && take_eq < eq_total;
    __stcg(c.first_out + a, truncated ? (t_out ? t : s.next) : 0u);
    __stcg(c.first_out_node + a, t_out ? static_cast<int>(s.first_out_node) : -1);
  }
  __syncthreads();  // the shared words are reused by the block's next row
}

// -- part 2: the rounds -------------------------------------------------------

// Does a row settle at an entry of base `b` (key `bk`, node `bn`) with
// the best so far (best, best_n; have)? See the header: the strict test,
// then the tail-run test.
__device__ __forceinline__ bool settles(float b, uint32_t bk, int bn, bool have,
                                        float best, int best_n, float lmin,
                                        uint32_t tail, uint32_t next) {
  const float bound = __fsub_rn(b, lmin);
  if (have ? bound < best : !(bound > 0.0f)) return true;
  if (!(have && bound == best && bn > best_n)) return false;
  // no later entry of this base wins the tie; a lower base gains less
  // than best if the next float below this base does, or, in the tail
  // run, the largest base below it
  if (__fsub_rn(key_value(bk - 1u), lmin) < best) return true;
  return bk == tail && (next == 0u || __fsub_rn(key_value(next), lmin) < best);
}

// One warp walks row a's list and posts its claim; a row the walk cannot
// settle is flagged and queued for a dense scan.
struct RowMeta {
  int len, start;
  uint32_t tail, next;
};

__device__ void walk_row(const Mig& c, int a, const RowMeta& m, const float* lam,
                         float lmin, bool skip_unfit, int par) {
  const int lane = threadIdx.x & 31;
  const int len = m.len;
  const int start = m.start;
  const uint32_t tail = m.tail;
  const uint32_t next = m.next;
  const float4 size = c.sizes[a];
  const int2* list = c.lists + static_cast<size_t>(a) * c.list_len;
  float best = -INFINITY;
  int best_n = INT_MAX;
  bool leading = skip_unfit;  // every entry so far failed to fit
  int new_start = start;
  bool settled = false;
  for (int c0 = start; c0 < len; c0 += 32) {
    const int e = c0 + lane;
    const bool valid = e < len;
    int node = 0;
    float b = 0.0f;
    float g = -INFINITY;
    if (valid) {
      const int2 ent = __ldcg(list + e);
      node = ent.x;
      b = __int_as_float(ent.y);
      g = __fsub_rn(b, lam != nullptr ? lam[node] : __ldcg(c.lam + node));
    }
    // usage and capacity only where the entry could beat the best so far,
    // or while the unfit head is still being measured
    const bool test = valid && (leading || (g > 0.0f && before(g, node, best, best_n)));
    bool fit = false;
    if (test) fit = fits(__ldcg(c.used + node), size, __ldg(c.capacity + node));
    const bool feas = fit && g > 0.0f;
    float k = feas ? g : -INFINITY;
    int r = feas ? node : INT_MAX;
    warp_argmax(k, r);
    if (before(k, r, best, best_n)) {
      best = k;
      best_n = r;
    }
    if (leading) {  // every valid entry of the chunk was tested
      const unsigned unfit = __ballot_sync(kFull, valid && !fit);
      const int lead = unfit == kFull ? 32 : __ffs(~unfit) - 1;
      new_start = c0 + lead;
      leading = lead == 32;
    }
    // the stop tests on the chunk's last entry
    const int last = min(31, len - 1 - c0);
    const float bl = __shfl_sync(kFull, b, last);
    const int nl = __shfl_sync(kFull, node, last);
    if (settles(bl, order_key(bl), nl, best_n != INT_MAX, best, best_n, lmin, tail, next)) {
      settled = true;
      break;
    }
  }
  if (!settled) {
    const uint32_t out = __ldcg(c.first_out + a);
    settled = out == 0u ||
              settles(key_value(out), out, __ldcg(c.first_out_node + a),
                      best_n != INT_MAX, best, best_n, lmin, tail, next);
  }
  if (lane == 0) {
    if (new_start != start) __stcg(c.start + a, new_start);
    if (!settled) {
      __stcg(c.flags + a, kDense);
      __stcg(c.queue + atomicAdd(c.queue_len, 1), a);
    } else if (best_n != INT_MAX) {
      post_claim(c, best_n, __float_as_uint(best), a, par);
    }
  }
}

__device__ void walk_phase(const Mig& c, const float* lam, float lmin, bool skip_unfit,
                           int par) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int a = blockIdx.x * kWarps + (threadIdx.x >> 5); a < c.a; a += warps) {
    // the row's state in one round trip
    const int dest = __ldcg(c.dest + a);
    const int flags = __ldcg(c.flags + a);
    const RowMeta m{__ldcg(c.len + a), __ldcg(c.start + a), __ldcg(c.tail + a),
                    __ldcg(c.next + a)};
    if (dest >= 0) continue;
    if (flags & kDense) {
      if (lane == 0) __stcg(c.queue + atomicAdd(c.queue_len, 1), a);
      continue;
    }
    walk_row(c, a, m, lam, lmin, skip_unfit, par);
  }
}

struct DenseShared {
  float4 cap[kTile];
  float4 used[kTile];
  float lam[kTile];
};

// Nodes of a dense tile: a multiple of 128 (a warp's 16-byte loads),
// small enough that the items cover the grid.
__device__ int dense_tile(const Mig& c, int groups) {
  long long t = static_cast<long long>(c.n) * groups / gridDim.x;
  t = t / 128 * 128;
  return static_cast<int>(t < 128 ? 128 : (t > kTile ? kTile : t));
}

__device__ void dense_phase(const Mig& c, DenseShared& s, int queued, int par) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (queued + kTileRows - 1) / kTileRows;
  const int tile = dense_tile(c, groups);
  const int tiles = (c.n + tile - 1) / tile;
  for (int item = blockIdx.x; item < tiles * groups; item += gridDim.x) {
    const int t = item % tiles;
    const int grp = item / tiles;
    const int lo = t * tile;
    const int len = min(tile, c.n - lo);
    __syncthreads();  // the last item's tile is consumed
    for (int j = threadIdx.x; j < len; j += kThreads) {
      s.cap[j] = c.capacity[lo + j];
      s.used[j] = __ldcg(c.used + lo + j);
      s.lam[j] = __ldcg(c.lam + lo + j);
    }
    __syncthreads();
#pragma unroll 1
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = grp * kTileRows + warp * 2 + rr;
      if (qi >= queued) break;
      const int a = __ldcg(c.queue + qi);
      const RowRef r = row_ref(c, a);
      const float4 size = c.sizes[a];
      float best = -INFINITY;
      int best_n = INT_MAX;
      const auto cell = [&](int j, float score, bool elig) {
        const int n = lo + j;
        const float g = __fsub_rn(
            __fsub_rn(__fsub_rn(score, r.cur_score), r.cost), s.lam[j]);
        if (elig && n != r.cur && g > 0.0f && fits(s.used[j], size, s.cap[j]) &&
            before(g, n, best, best_n)) {
          best = g;
          best_n = n;
        }
      };
      if (c.vec) {
#pragma unroll 2
        for (int j = 4 * lane; j < len; j += 128) {
          const float4 sc = __ldcs(reinterpret_cast<const float4*>(r.scores + lo + j));
          const unsigned el = __ldcs(reinterpret_cast<const unsigned*>(r.eligible + lo + j));
          cell(j, sc.x, (el & 0xffu) != 0);
          cell(j + 1, sc.y, (el & 0xff00u) != 0);
          cell(j + 2, sc.z, (el & 0xff0000u) != 0);
          cell(j + 3, sc.w, (el & 0xff000000u) != 0);
        }
      } else {
        for (int j = lane; j < len; j += 32) {
          cell(j, __ldcs(r.scores + lo + j), __ldcs(r.eligible + lo + j) != 0);
        }
      }
      warp_argmax(best, best_n);
      if (lane == 0) {
        if (best_n != INT_MAX) {
          atomicMax(c.row_word + qi, (static_cast<unsigned long long>(__float_as_uint(best)) << 32) |
                                         (kFull - static_cast<unsigned>(best_n)));
        }
        __threadfence();
        if (atomicAdd(c.row_done + qi, 1) == tiles - 1) {
          // every tile of the row has merged: post its claim
          __threadfence();
          const unsigned long long w = atomicExch(c.row_word + qi, 0ULL);
          atomicExch(c.row_done + qi, 0);
          if (w != 0ULL) {
            post_claim(c, static_cast<int>(kFull - static_cast<unsigned>(w)),
                       static_cast<unsigned>(w >> 32), a, par);
          }
        }
      }
    }
  }
}

// Node pass of this block's slice; returns the round's claimed nodes.
__device__ int node_pass(const Mig& c, int moves0, int par, int* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the claimed nodes of the slices below this one, and of all
  int below = 0, total = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const int v = __ldcg(c.slices + par * kMaxGrid + b);
    total += v;
    below += b < static_cast<int>(blockIdx.x) ? v : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    below += __shfl_xor_sync(kFull, below, off);
    total += __shfl_xor_sync(kFull, total, off);
  }
  if (lane == 0) {
    s_red[warp] = below;
    s_red[kWarps + warp] = total;
  }
  __syncthreads();
  below = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    below += s_red[w];
    total += s_red[kWarps + w];
  }
  __syncthreads();
  const long long room = static_cast<long long>(c.budget) - moves0;
  const int slice = slice_len(c);
  const int lo = blockIdx.x * slice;
  const int hi = min(c.n, lo + slice);
  int carried = below;  // claimed nodes before this chunk
  unsigned least = 0;   // inverted order key of the least new price
  for (int base = lo; base < hi; base += kThreads) {
    const int node = base + static_cast<int>(threadIdx.x);
    const bool in = node < hi;
    const int count = in ? __ldcg(c.claims + node) : 0;
    const bool has = count > 0;
    const unsigned ballot = __ballot_sync(kFull, has);
    if (lane == 0) s_red[warp] = __popc(ballot);
    __syncthreads();
    int under = 0, chunk = 0;
    for (int w = 0; w < kWarps; ++w) {
      under += w < warp ? s_red[w] : 0;
      chunk += s_red[w];
    }
    __syncthreads();  // s_red is rewritten by the next chunk
    if (in) {
      const int rank = carried + under + __popc(ballot & ((1u << lane) - 1u));
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
      if (l == l) least = max(least, ~order_key(l));
      if (has) {
        __stcg(c.claims + node, 0);
        __stcg(c.key + node, 0ull);
      }
    }
    carried += chunk;
  }
  least = warp_max(least);
  if (lane == 0 && least != 0u) atomicMax(c.lam_min + (par ^ 1), least);
  if (threadIdx.x == 0) {
    // next round's slice counts start from zero
    __stcg(c.slices + (par ^ 1) * kMaxGrid + blockIdx.x, 0);
    if (blockIdx.x == 0) __stcg(c.queue_len, 0);
  }
  return total;
}

// Part 1, its own launch: lam_min of lam0, whether any size component is
// negative, and every row's list (a block a row, as many blocks as rows).
__global__ void __launch_bounds__(kThreads) build_kernel(Mig c) {
  __shared__ BuildShared s;
  extern __shared__ uint32_t staged_keys[];  // [N] when N <= kStageMax
  if (blockIdx.x == 0) {
    unsigned least = 0;
    int negative = 0;
    for (int i = threadIdx.x; i < max(c.n, c.a); i += kThreads) {
      if (i < c.n) {
        const float l = c.lam[i];
        if (l == l) least = max(least, ~order_key(l));
      }
      if (i < c.a) {
        const float4 z = c.sizes[i];
        negative |= (z.x < 0.0f) | (z.y < 0.0f) | (z.z < 0.0f) | (z.w < 0.0f);
      }
    }
    least = warp_max(least);
    if ((threadIdx.x & 31) == 0 && least != 0u) atomicMax(c.lam_min, least);
    if (__syncthreads_or(negative) && threadIdx.x == 0) atomicOr(c.negative, 1);
  }
  uint32_t* keys = c.n <= kStageMax ? staged_keys : nullptr;
  for (int a = blockIdx.x; a < c.a; a += gridDim.x) build_row(c, s, keys, a);
}

// Part 2, one cooperative launch: the rounds.
__global__ void __launch_bounds__(kThreads) migrate_kernel(Mig c) {
  extern __shared__ float staged_lam[];  // [N] when c.stage_lam
  float* lam = c.stage_lam ? staged_lam : nullptr;
  __shared__ DenseShared s_dense;
  __shared__ int s_red[2 * kWarps];
  __shared__ int s_flag;
  const bool skip_unfit = __ldcg(c.negative) == 0;

  int moves = 0, rounds = 0;
  for (int it = 0; it < c.steps; ++it) {
    const int par = it & 1;
    const float lmin = lam_min_value(__ldcg(c.lam_min + par));
    if (blockIdx.x == 0 && threadIdx.x == 0) __stcg(c.lam_min + (par ^ 1), 0u);
    if (lam != nullptr) {
      // this round's prices, every node's, staged for the walks' gathers
      for (int i = threadIdx.x; i < c.n; i += kThreads) lam[i] = __ldcg(c.lam + i);
      __syncthreads();
    }
    walk_phase(c, lam, lmin, skip_unfit, par);
    grid_barrier(c.barrier);
    if (threadIdx.x == 0) s_flag = __ldcg(c.queue_len);
    __syncthreads();
    const int queued = s_flag;
    if (queued > 0) {
      dense_phase(c, s_dense, queued, par);
      grid_barrier(c.barrier);
    }
    const int claimed = node_pass(c, moves, par, s_red);
    const long long room = static_cast<long long>(c.budget) - moves;
    const long long won = claimed < room ? claimed : (room > 0 ? room : 0);
    moves += static_cast<int>(won);
    rounds += claimed > 0;
    if (!(claimed > 0 && moves < c.budget)) break;
    grid_barrier(c.barrier);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    __stcg(c.moves, moves);
    __stcg(c.rounds, rounds);
  }
}

// Nothing but grid barriers: what one costs on this card, for the record.
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(unsigned* bar, int iters) {
  for (int i = 0; i < iters; ++i) grid_barrier(bar);
}

// Dynamic shared memory over N nodes: the build's staged keys, the
// rounds' staged prices.
int staged_bytes(int n) {
  return n <= kStageMax ? n * static_cast<int>(sizeof(uint32_t)) : 0;
}

// The rounds' grid over N nodes: as many 512-thread blocks as are
// resident with the staged prices' shared memory, which is opted in here.
cudaError_t resident_grid(int n, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(migrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           staged_bytes(kStageMax));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, migrate_kernel, kThreads,
                                                    staged_bytes(n));
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = sms * per_sm < kMaxGrid ? sms * per_sm : kMaxGrid;
  return cudaSuccess;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int list_len(int n) { return n < kList ? n : kList; }

}  // namespace

// C entry points, bound with ctypes (nomad_tpu_torch/device/migrate.py).

// Words of the zero-filled int32 scratch `nomad_migrate_plan` takes for A
// allocs and N nodes (each row's candidate list is most of it); a
// negative cudaError on failure.
extern "C" long long nomad_migrate_scratch_words(int a, int n) {
  if (a < 1 || n < 1) return -static_cast<long long>(cudaErrorInvalidValue);
  return layout(a, n, list_len(n)).total;
}

// Two launches on `stream`, the lists' build and the rounds' cooperative
// launch; allocates nothing and returns the launches' error (0 when both
// were accepted). `d` must be 4 (capacity, used
// and sizes are read as one float4 a row, 16-byte aligned). `used`,
// `lam`, `dest`, `gains`, `moves` and `rounds` hold their initial values
// on entry; `scratch` holds nomad_migrate_scratch_words(a, n) zeroed
// words.
extern "C" int nomad_migrate_plan(
    const float* capacity, const float* sizes, const int32_t* cur,
    const uint8_t* eligible, const float* scores, const float* cur_scores,
    const float* move_cost, int a, int n, int d, int budget, int steps,
    int32_t* scratch, float* used, float* lam, int32_t* dest, float* gains,
    int32_t* moves, int32_t* rounds, void* stream) {
  if (a < 1 || n < 1 || d != 4 || steps < 1 || !aligned(capacity, 16) ||
      !aligned(sizes, 16) || !aligned(used, 16) || !aligned(scratch, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  cudaError_t e = resident_grid(n, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           staged_bytes(kStageMax));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int k = list_len(n);
  const Layout l = layout(a, n, k);
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
  c.list_len = k;
  c.vec = n % 4 == 0 && aligned(scores, 16) && aligned(eligible, 4);
  // staging costs every block N prices a round; it pays where the walks'
  // price gathers (a chunk of 32 sectors a row, at least) outweigh that
  c.stage_lam = n <= kStageMax &&
                static_cast<long long>(a) * 32 * 32 >= static_cast<long long>(grid) * n * 4;
  c.barrier = reinterpret_cast<unsigned*>(scratch);
  c.queue_len = scratch + 2;
  c.negative = scratch + 3;
  c.lam_min = reinterpret_cast<unsigned*>(scratch + 4);
  c.key = reinterpret_cast<unsigned long long*>(scratch + l.key);
  c.claims = scratch + l.claims;
  c.slices = scratch + l.slices;
  c.queue = scratch + l.queue;
  c.row_word = reinterpret_cast<unsigned long long*>(scratch + l.row_word);
  c.row_done = scratch + l.row_done;
  c.start = scratch + l.start;
  c.len = scratch + l.len;
  c.flags = scratch + l.flags;
  c.tail = reinterpret_cast<unsigned*>(scratch + l.tail);
  c.next = reinterpret_cast<unsigned*>(scratch + l.next);
  c.first_out = reinterpret_cast<unsigned*>(scratch + l.first_out);
  c.first_out_node = scratch + l.first_out_node;
  c.lists = reinterpret_cast<int2*>(scratch + l.lists);
  c.used = reinterpret_cast<float4*>(used);
  c.lam = lam;
  c.dest = dest;
  c.gains = gains;
  c.moves = moves;
  c.rounds = rounds;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  build_kernel<<<a, kThreads, staged_bytes(n), st>>>(c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(migrate_kernel),
                                  dim3(grid), dim3(kThreads), args,
                                  c.stage_lam ? staged_bytes(n) : 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// `iters` grid barriers in one cooperative launch of the auction's grid
// (at N up to 16,384) on `stream`; `scratch` holds 2 zeroed words.
// Returns the launch's error.
extern "C" int nomad_migrate_barrier_probe(int iters, int32_t* scratch, void* stream) {
  if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t e = resident_grid(kStageMax, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  void* args[] = {&bar, &iters};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_probe_kernel),
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
