// Preemption search on Hopper (sm_90a).
//
// Replaces nomad_tpu/device/preempt.py:find_preemption_kernel and
// choose_preemption_node_kernel.
//
// find_preemption, one pass per node row: key each victim by
// prio * 1e4 + min(dist, 9e3) (1e9 for padding), where dist is the L2
// norm of (victim - ask) / max(ask, 1) over the four dimensions; sort the
// row by the composite (order_key(key) << 32 | index), which is
// jnp.argsort's stable order (ties by index); prefix-sum the sorted,
// masked victim resources and priorities; the first prefix after which
// used - freed + ask <= capacity in every dimension gives k (and the net
// priority at k - 1); a node is feasible when one exists and the node is
// eligible.
//
// choose_preemption_node, on the pass's outputs: per feasible node, the
// binpack fit after freeing every masked victim (not the prefix: the
// reference's own approximation) and placing the ask, clip((20 - 10^ff0)
// - 10^ff1, 0, 18) / 18, times 1 / (1 + exp((net - 2048) / 256)); -inf on
// infeasible nodes; then the first-index argmax over nodes.
//
// What bounds it on the H100: bytes. Each victim is 21 bytes of input
// (four f32 resources, an i32 priority, a mask byte) plus a 4-byte order
// entry written, and the arithmetic per victim (a distance, a sort step
// per network stage, a prefix add) is a few dozen operations, far under
// the f32 rate. At the path's shape (16,384 nodes, V 8) that is ~3.3 MB,
// about a microsecond at 3.35 TB/s; the launches' own latency is larger.
//
// Design of the find pass, by padded width Vp (the next power of two of
// V); find_plan picks the form:
//  - Vp <= 32 (the path's width: a handful of allocations per node), a
//    warp: one warp holds 32 / Vp rows, one victim a lane, loaded once
//    (a 16-byte float4, its priority, its mask byte) and kept in
//    registers. A bitonic network of register shuffles sorts each row's
//    segment; each lane then takes its sorted victim's record from the
//    lane that holds it (__shfl_sync from lane seg * Vp + index), shuffle
//    scans give the prefixes, and a ballot finds the first fitting
//    prefix. find_warp_pass is that pass; it runs alone in
//    find_warp_kernel and inside the choice's warp-form kernel
//    (choose_kernel<true>), so that a choose_preemption_node call at
//    V <= 32 is one kernel node: the warp writes its rows' outputs and
//    hands feasible and net from registers to the choice's scoring.
//  - 32 < Vp <= kRowWidth (1,024), a warp a row, kRowWarps rows a block:
//    each lane keeps Vp / 32 sort words in registers (victims lane,
//    lane + 32, ... loaded coalesced), read as positions lane * E + e of
//    one bitonic network: strides below E inside the lane, larger ones by
//    shuffles, so no stage waits at a barrier. The row's records are
//    staged once, as float4s, in the warp's slice of shared memory, so the
//    gather after the sort and the scan read shared memory; the lanes'
//    runs are scanned by shuffles and the first fit is a ballot and
//    __ffs over the lanes' runs, in order.
//  - Vp > kRowWidth, a row over a thread-block cluster of S blocks
//    (find_cluster_kernel), block r holding positions [r * slice, (r + 1)
//    * slice) of the row in its shared memory. A stable LSD radix sort of
//    the 32-bit order_key, 8-bit digits: each block counts its slice's
//    digits, the counts are summed over the cluster through distributed
//    shared memory (DSMEM), and each word goes to its position in the row
//    (the words of lower digits in the whole row, then of its digit in
//    the slices before its block, then before it in its own slice: a
//    warp's __match_any_sync rank on top of the warps before it), written
//    into the owning block's other buffer over DSMEM. A pass places its
//    slice in rounds of 512 positions (1,024, two a thread, on slices
//    above kWideSlice), two block barriers a round: the warps' counts of
//    each digit are bytes, and a lane scans 8 or 16 of one digit's counts
//    from one word (a digit's counts in one bank cost a 16-way conflict,
//    4 k cycles a round). Four stable passes from index order give (key,
//    index) order, the 64-bit word sort's. A pass whose digit is the same
//    for the whole row is skipped. Then each block scans its sorted
//    slice, the slices' totals are exchanged over DSMEM, and the first fit
//    is the minimum over the cluster. S is picked by find_plan from the
//    shape and cudaOccupancyMaxActiveClusters.
//  - Rows past a cluster's shared memory (16 blocks of kClusterSlice
//    words): the resident blocks loop over the rows with their Vp sort
//    words in a global scratch the wrapper allocates (a bitonic network
//    through L1 and L2). Every form keeps a victim's index in a word's low
//    32 bits: V <= 2^30.
//
// The choice:
//  - V <= 32: a warp holds 32 / vp rows, one victim a lane, so its loads
//    are one contiguous run of 16-byte victim records and mask bytes (at
//    V 8, four rows a warp), loaded whatever the mask says and masked by a
//    select; a butterfly of shuffles inside each row's Vp lanes sums the
//    row, and its first lane scores it. V > 32: one warp a row, each lane
//    adding every 32nd victim with 16-byte loads, then a butterfly. The
//    argmax is a block reduction of (order_key(score) << 32 | ~row) words
//    and a 64-bit atomicMax across blocks (the largest score, then the
//    lowest row, whatever the atomics' order); the last block to finish
//    decodes it.
//  - choose is one kernel node a call, with no memset: its two-word
//    cross-block scratch (the best word, the finished blocks) must be
//    zero when a launch starts, and the last block, after it has read
//    the word, sets both back to zero, so every launch leaves it zero.
//    The wrapper keeps one scratch per device and stream, zeroed once
//    when made (never during a graph capture: a stream is called once
//    eagerly before it is captured): launches on one stream run one
//    after another (a CUDA graph replays its captured launches in their
//    order), so each finds it zero, and eager launches on different
//    streams never share one. A captured graph keeps the scratch of its
//    capture stream, so it must not replay while a launch on that stream
//    (eager, or another replay of a graph captured there) can run
//    alongside it: replay it on its capture stream, or order the streams.
//
// Numerics: IEEE division, sqrt and expf (no fast math) and the build's
// -fmad=false, so the key, the free fractions and the score round as the
// separately rounded reference ops do. The prefix sums add in scan order,
// not sequentially, and the choice's freed totals in index order or in a
// warp's tree: all exact on integer-valued resources (MHz, MiB) while
// every partial sum stays below 2^24, whatever the order. k and net
// depend only on the prefixes up to the first that fits; a node whose
// cpu or memory total passes 2^24 frees so much that its fit clips to 0
// either way.

#include <cooperative_groups.h>

#include <initializer_list>

#include "candidate.cuh"
#include "cluster.cuh"

namespace cg = cooperative_groups;

// Stage clocks for tools/preempt_find_profile.py, compiled in only with
// -DNOMAD_PREEMPT_PROFILE: thread 0 of each of the first 16 blocks adds
// the clock64 cycles since its last lap to its slot i (its waits at
// barriers included), and block 0 counts the launches in slot 15.
// Slots: 0 key, 1 sort, 2 gather, 3 scan and fit, 4 write, 5 choice; the
// cluster form's sort split into 6 digit counts, 7 their exchange, 8 the
// rounds and 9 the wait for every word to land.
#ifdef NOMAD_PREEMPT_PROFILE
__device__ long long g_prof[16][16];
#define PROF_START() long long prof_t = clock64()
#define PROF_PARAM , long long& prof_t
#define PROF_ARG , prof_t
#define PROF_LAP(i)                                          \
  do {                                                       \
    if (blockIdx.x < 16 && threadIdx.x == 0) {               \
      const long long prof_now = clock64();                  \
      g_prof[blockIdx.x][i] += prof_now - prof_t;            \
      prof_t = prof_now;                                     \
    }                                                        \
  } while (0)
#define PROF_END()                                           \
  do {                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_prof[0][15] += 1; \
  } while (0)
extern "C" int nomad_preempt_profile(long long* host, int reset) {
  if (reset) {
    static const long long zero[16][16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));
}
#else
#define PROF_START()
#define PROF_PARAM
#define PROF_ARG
#define PROF_LAP(i)
#define PROF_END()
#endif

namespace {

constexpr int kMaxVictimWidth = 1 << 30;  // Vp in an int, index in 32 bits
constexpr int kWarpThreads = 256;         // warp form: 8 warps a block
constexpr int kRowWidth = 1024;           // warp-a-row form: the widest Vp
constexpr int kRowWarps = 4;              // warp-a-row form: rows a block
constexpr int kBatch = 8;                 // warp-a-row form: loads a lane keeps in flight
constexpr int kClusterThreads = 512;      // cluster form: threads a block
constexpr int kClusterWarps = kClusterThreads / 32;
static_assert(kClusterWarps == 16, "the offsets' scan: 16 digits a warp, two lanes a digit");
constexpr int kWideSlice = 2048;          // cluster form: two positions a thread a round above
constexpr int kMaxCluster = 16;           // cluster form: blocks a row (non-portable)
constexpr int kClusterSlice = 12288;      // cluster form: most positions a block holds
constexpr int kBins = 256;                // cluster form: 8-bit radix digits
constexpr int kChooseThreads = 256;
constexpr int kGlobalThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadWord = ~0ULL;

// The forms, as nomad_find_preemption reports the one it launched.
enum Form { kFormWarp = 0, kFormRow = 1, kFormCluster = 2, kFormGlobal = 3 };

struct Pass {
  const float* capacity;       // [N, 4]
  const float* used;           // [N, 4]
  const float* ask;            // [4]
  const uint8_t* eligible;     // [N]
  const float* victim_res;     // [N, V, 4]
  const int32_t* victim_prio;  // [N, V]
  const uint8_t* victim_mask;  // [N, V]
  int n;
  int v;
  uint8_t* feasible;           // [N]
  int32_t* k;                  // [N]
  float* net;                  // [N]
  int32_t* order;              // [N, V]
};

// One victim's record: its resources, priority and mask.
struct Victim {
  float4 res;
  int prio;
  bool mask;
};

__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ Victim load_victim(const Pass& p, size_t rv) {
  return Victim{load4(p.victim_res + 4 * rv), p.victim_prio[rv], p.victim_mask[rv] != 0};
}

__device__ __forceinline__ float4 load_ask(const Pass& p) {
  return make_float4(p.ask[0], p.ask[1], p.ask[2], p.ask[3]);
}

// The order of a victim's sort key. The squares are summed by a chain of
// explicit fused multiply-adds in dimension order, as the reference's
// jnp.sum(rel * rel, axis=-1) compiles on the CPU (-fmad=false only stops
// the compiler from contracting on its own).
__device__ uint32_t victim_key(const float4& ask, const Victim& x) {
  if (!x.mask) return order_key(1e9f);
  const float a[4] = {ask.x, ask.y, ask.z, ask.w};
  const float r[4] = {x.res.x, x.res.y, x.res.z, x.res.w};
  float sum = 0.0f;
  for (int d = 0; d < 4; ++d) {
    const float rel = __fdiv_rn(__fsub_rn(r[d], a[d]), fmaxf(a[d], 1.0f));
    sum = __fmaf_rn(rel, rel, sum);
  }
  const float dist = __fsqrt_rn(sum);
  return order_key(__fadd_rn(__fmul_rn(static_cast<float>(x.prio), 1e4f), fminf(dist, 9e3f)));
}

// Sort word of victim i of a row: its key's order, then its index.
__device__ __forceinline__ unsigned long long sort_word(uint32_t key, int i) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(i);
}

__device__ unsigned long long victim_word(const Pass& p, const float4& ask, int row, int i) {
  return sort_word(victim_key(ask, load_victim(p, static_cast<size_t>(row) * p.v + i)), i);
}

// Does the ask fit once `freed` is released from a node at `used` of
// `cap`?
__device__ __forceinline__ bool fits(const float4& used, const float4& cap, const float4& ask,
                                     const float4& freed) {
  return __fadd_rn(__fsub_rn(used.x, freed.x), ask.x) <= cap.x &&
         __fadd_rn(__fsub_rn(used.y, freed.y), ask.y) <= cap.y &&
         __fadd_rn(__fsub_rn(used.z, freed.z), ask.z) <= cap.z &&
         __fadd_rn(__fsub_rn(used.w, freed.w), ask.w) <= cap.w;
}

__device__ void write_row(const Pass& p, int row, bool any, int first, int net) {
  p.feasible[row] = any ? 1 : 0;
  p.k[row] = any ? first + 1 : 0;
  p.net[row] = any ? static_cast<float>(net) : 0.0f;
}

// A row's feasible and net, as the find pass wrote them.
struct RowFit {
  bool feasible;
  float net;
};

// Inclusive scan over the warp's lanes (within segments of `width`) of a
// float4 and an int.
__device__ __forceinline__ void warp_scan(float4& x, int& prio, int lane, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const float4 up = make_float4(__shfl_up_sync(kFull, x.x, off, width),
                                  __shfl_up_sync(kFull, x.y, off, width),
                                  __shfl_up_sync(kFull, x.z, off, width),
                                  __shfl_up_sync(kFull, x.w, off, width));
    const int up_prio = __shfl_up_sync(kFull, prio, off, width);
    if ((lane & (width - 1)) >= off) {
      x = add4(x, up);
      prio += up_prio;
    }
  }
}

// -- V <= 32: a warp ----------------------------------------------------------

// The find pass of a warp's 32 / width rows (`width` the next power of
// two of V): lane l holds victim l % width of row `row` (p.n where the
// warp runs past the last row) in `x` (zero and unmasked where it holds
// none). Writes the row's outputs and returns its feasible and net on
// every lane of the row's segment.
__device__ RowFit find_warp_pass(const Pass& p, const float4& ask, int width, int row,
                                 const Victim& x PROF_PARAM) {
  const int lane = threadIdx.x & 31;
  const int seg = lane / width;
  const int sub = lane & (width - 1);
  const bool in_row = row < p.n;
  const bool slot = in_row && sub < p.v;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 cap = in_row ? load4(p.capacity + 4 * static_cast<size_t>(row)) : zero;
  const float4 used = in_row ? load4(p.used + 4 * static_cast<size_t>(row)) : zero;
  const bool eligible = in_row && p.eligible[row] != 0;

  unsigned long long w = slot ? sort_word(victim_key(ask, x), sub) : kPadWord;
  PROF_LAP(0);
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, w, stride);
      const bool ascending = (sub & size) == 0;
      const bool lower = (sub & stride) == 0;
      w = (lower == ascending) ? (o < w ? o : w) : (o > w ? o : w);
    }
  }
  PROF_LAP(1);
  // padding words sort last, so slot `sub` holds the sub-th victim of the
  // row; its record is in a register of lane seg * width + index
  const unsigned idx = static_cast<unsigned>(w & 0xffffffffu);
  const int src = seg * width + static_cast<int>(idx & static_cast<unsigned>(width - 1));
  const float4 r = make_float4(__shfl_sync(kFull, x.res.x, src), __shfl_sync(kFull, x.res.y, src),
                               __shfl_sync(kFull, x.res.z, src), __shfl_sync(kFull, x.res.w, src));
  const int r_prio = __shfl_sync(kFull, x.prio, src);
  const int r_mask = __shfl_sync(kFull, static_cast<int>(x.mask), src);
  const bool real = slot && r_mask != 0;
  float4 freed = real ? r : zero;
  int prio = real ? r_prio : 0;
  PROF_LAP(2);
  if (slot) p.order[static_cast<size_t>(row) * p.v + sub] = static_cast<int>(idx);
  warp_scan(freed, prio, lane, width);
  const bool fit = real && fits(used, cap, ask, freed);
  const unsigned bits = __ballot_sync(kFull, fit);
  const unsigned seg_bits =
      (bits >> (seg * width)) & (width == 32 ? kFull : ((1u << width) - 1u));
  const int first = __ffs(seg_bits) - 1;
  const int net = __shfl_sync(kFull, prio, seg * width + (first < 0 ? 0 : first));
  const bool any = seg_bits != 0 && eligible;
  PROF_LAP(3);
  if (in_row && sub == 0) write_row(p, row, any, first, net);
  PROF_LAP(4);
  return RowFit{any, any ? static_cast<float>(net) : 0.0f};
}

// The find pass alone, V <= 32: each warp holds 32 / width rows.
__global__ void __launch_bounds__(kWarpThreads)
find_warp_kernel(Pass p, int width) {
  PROF_START();
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long wide_row = warp * (32 / width) + lane / width;
  const int row = wide_row < p.n ? static_cast<int>(wide_row) : p.n;
  const int sub = lane & (width - 1);
  Victim x{make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0, false};
  if (row < p.n && sub < p.v) x = load_victim(p, static_cast<size_t>(row) * p.v + sub);
  find_warp_pass(p, load_ask(p), width, row, x PROF_ARG);
  PROF_END();
}

// -- 32 < Vp <= kRowWidth: a warp a row ---------------------------------------

// A row's records in its warp's slice of shared memory, Vp = 32 * E.
template <int E>
struct RowSlice {
  float4 res[32 * E];     // masked resources (zero where unmasked)
  int prio[32 * E];       // masked priorities
  int order[33 * E];      // the sorted indices, position q at q + q / 32
  uint8_t mask[32 * E];
};

template <int E>
__host__ __device__ constexpr int log2_of() {
  return E <= 1 ? 0 : 1 + log2_of<E / 2>();
}

template <int E>
__global__ void __launch_bounds__(32 * kRowWarps)
find_row_warp_kernel(Pass p) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  RowSlice<E>& s = reinterpret_cast<RowSlice<E>*>(row_smem)[threadIdx.x >> 5];
  PROF_START();
  const int lane = threadIdx.x & 31;
  const long long wide_row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (wide_row >= p.n) return;  // the whole warp: no block barrier follows
  const int row = static_cast<int>(wide_row);
  const size_t row_v = static_cast<size_t>(row) * p.v;
  const float4 ask = load_ask(p);
  const float4 cap = load4(p.capacity + 4 * static_cast<size_t>(row));
  const float4 used = load4(p.used + 4 * static_cast<size_t>(row));
  const bool eligible = p.eligible[row] != 0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // key: lane l stages victims l, l + 32, ... and keeps their words,
  // kBatch loads in flight before the first is used
  unsigned long long w[E];
#pragma unroll
  for (int e0 = 0; e0 < E; e0 += kBatch) {
    Victim xs[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch && e0 + u < E; ++u) {
      xs[u] = load_victim(p, row_v + min(lane + 32 * (e0 + u), p.v - 1));
    }
#pragma unroll
    for (int u = 0; u < kBatch && e0 + u < E; ++u) {
      const int i = lane + 32 * (e0 + u);
      w[e0 + u] = kPadWord;
      if (i < p.v) {
        const Victim& x = xs[u];
        s.res[i] = x.mask ? x.res : zero;
        s.prio[i] = x.mask ? x.prio : 0;
        s.mask[i] = x.mask ? 1 : 0;
        w[e0 + u] = sort_word(victim_key(ask, x), i);
      }
    }
  }
  PROF_LAP(0);
  // sort: the words are positions lane * E + e of one bitonic network
  // (which word starts where does not matter: the words are distinct)
#pragma unroll
  for (int ls = 1; ls <= 5 + log2_of<E>(); ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls;
      const int stride = 1 << lt;
      if (stride < E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & stride) == 0) {
            const int f = e | stride;
            const bool ascending = ((lane * E + e) & size) == 0;
            const unsigned long long a = w[e];
            const unsigned long long b = w[f];
            const bool swap = (a > b) == ascending;
            w[e] = swap ? b : a;
            w[f] = swap ? a : b;
          }
        }
      } else {
        const int lanes = stride / E;
        const bool lower = (lane & lanes) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long o = __shfl_xor_sync(kFull, w[e], lanes);
          const bool ascending = ((lane * E + e) & size) == 0;
          w[e] = (lower == ascending) ? (o < w[e] ? o : w[e]) : (o > w[e] ? o : w[e]);
        }
      }
    }
  }
  PROF_LAP(1);
  __syncwarp();  // the staged records
  // gather: this lane's run of positions lane * E .. + E - 1, its totals
  float4 total = zero;
  int total_prio = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = lane * E + e;
    if (q < p.v) {
      const int idx = static_cast<int>(w[e] & 0xffffffffu);
      s.order[q + (q >> 5)] = idx;
      total = add4(total, s.res[idx]);
      total_prio += s.prio[idx];
    }
  }
  PROF_LAP(2);
  // the runs before this lane's, then the run walked in order
  float4 inc = total;
  int inc_prio = total_prio;
  warp_scan(inc, inc_prio, lane, 32);
  float4 freed = make_float4(__shfl_up_sync(kFull, inc.x, 1), __shfl_up_sync(kFull, inc.y, 1),
                             __shfl_up_sync(kFull, inc.z, 1), __shfl_up_sync(kFull, inc.w, 1));
  int prio = __shfl_up_sync(kFull, inc_prio, 1);
  if (lane == 0) {
    freed = zero;
    prio = 0;
  }
  int first = -1;
  int net = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = lane * E + e;
    if (q < p.v && first < 0) {
      const int idx = static_cast<int>(w[e] & 0xffffffffu);
      freed = add4(freed, s.res[idx]);
      prio += s.prio[idx];
      if (s.mask[idx] && fits(used, cap, ask, freed)) {
        first = q;
        net = prio;
      }
    }
  }
  const unsigned hit = __ballot_sync(kFull, first >= 0);
  const int src = hit != 0 ? __ffs(hit) - 1 : 0;
  first = __shfl_sync(kFull, first, src);
  net = __shfl_sync(kFull, net, src);
  PROF_LAP(3);
  __syncwarp();  // the staged order
  for (int i = lane; i < p.v; i += 32) p.order[row_v + i] = s.order[i + (i >> 5)];
  if (lane == 0) write_row(p, row, hit != 0 && eligible, first, net);
  PROF_LAP(4);
  PROF_END();
}

template <int E>
constexpr size_t row_smem_bytes() {
  return kRowWarps * sizeof(RowSlice<E>);
}

// -- Vp > kRowWidth: a row over a cluster -------------------------------------

// A cluster block's shared memory before its two word buffers, for
// rounds of H positions a thread (H * 16 round warps of 32 positions).
template <int H>
struct ClusterShared {
  // a round's counts by digit and round warp (the offsets' scan clears them)
  uint8_t counts[kBins][16 * H];
  // the offset in the round of each digit's words in each round warp (a
  // word of padding a digit, so that a warp's digits spread over banks)
  uint16_t offset[kBins][16 * H + 2];
  uint32_t round_base[kBins];  // the round's first position of each digit
  uint32_t hist[kBins];    // the slice's digit counts (the cluster reads them)
  uint32_t base[kBins];    // the next position of each digit's words from this slice
  uint32_t digit_warp[kBins / 32];
  float4 warp_total[kClusterWarps];
  int warp_prio[kClusterWarps];
  float4 slice_total;      // the slice's totals (the cluster reads them)
  int slice_prio;
  float4 slice_before;     // the totals of the slices before this one
  int prio_before;
  unsigned long long hit;  // the slice's first fit (the rank-0 block reads it)
  int skip;
};

template <int H>
constexpr size_t kClusterHeader = (sizeof(ClusterShared<H>) + 15) / 16 * 16;

// Positions a thread holds a round for a slice: more rounds cost more
// barriers, larger ones idle threads on a small slice.
__host__ __device__ constexpr int round_positions(int slice) { return slice > kWideSlice ? 2 : 1; }

__host__ __device__ constexpr size_t cluster_smem_bytes(int slice) {
  return (round_positions(slice) == 2 ? kClusterHeader<2> : kClusterHeader<1>) +
         2 * sizeof(unsigned long long) * static_cast<size_t>(slice);
}

template <int H>
__global__ void __launch_bounds__(kClusterThreads)
find_cluster_kernel(Pass p, int slice) {
  constexpr int kRound = H * kClusterThreads;  // positions a round
  constexpr int kRoundWarps = 16 * H;          // a round's warps of 32 positions
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  ClusterShared<H>& sh = *reinterpret_cast<ClusterShared<H>*>(cluster_smem);
  unsigned long long* const bufs =
      reinterpret_cast<unsigned long long*>(cluster_smem + kClusterHeader<H>);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = static_cast<int>(blockIdx.x / cs);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = rank * slice;
  const int count = max(0, min(p.v - lo, slice));
  const size_t row_v = static_cast<size_t>(row) * p.v;
  const float4 ask = load_ask(p);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  PROF_START();

  if (tid == 0) sh.hit = kPadWord;
  for (int t = tid; t < kBins * kRoundWarps / 8; t += kClusterThreads) {
    reinterpret_cast<uint2*>(&sh.counts[0][0])[t] = make_uint2(0, 0);
  }
  const float inv_slice = 1.0f / static_cast<float>(slice);
  for (int j = tid; j < count; j += kClusterThreads) {
    bufs[j] = victim_word(p, ask, row, lo + j);
  }
  PROF_LAP(0);
  int cur = 0;
  for (int shift = 32; shift < 64; shift += 8) {
    const unsigned long long* src = bufs + cur * slice;
    if (tid < kBins) sh.hist[tid] = 0;
    if (tid == 0) sh.skip = 0;
    __syncthreads();
    for (int r0 = 0; r0 < count; r0 += kClusterThreads) {
      const int j = r0 + tid;  // the same trip count on every thread
      const uint32_t d =
          j < count ? static_cast<uint32_t>((src[j] >> shift) & (kBins - 1)) : kBins;
      const unsigned peers = __match_any_sync(kFull, d);
      if (d < kBins && __ffs(peers) - 1 == lane) atomicAdd(&sh.hist[d], __popc(peers));
    }
    PROF_LAP(6);
    cluster.sync();  // every slice's counts are in
    // the digit's first position from this slice: the row's words of
    // lower digits, then this digit's in the slices before this one
    uint32_t total = 0, before = 0, inc = 0;
    if (tid < kBins) {
      for (int r = 0; r < cs; ++r) {
        const uint32_t c = cluster.map_shared_rank(sh.hist, r)[tid];
        total += c;
        before += r < rank ? c : 0;
      }
      inc = total;
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t up = __shfl_up_sync(kFull, inc, off);
        inc += lane >= off ? up : 0;
      }
      if (lane == 31) sh.digit_warp[warp] = inc;
    }
    __syncthreads();
    if (tid < kBins) {
      uint32_t ex = inc - total;
      for (int w = 0; w < warp; ++w) ex += sh.digit_warp[w];
      sh.base[tid] = ex + before;
      if (total == static_cast<uint32_t>(p.v)) sh.skip = 1;  // one digit for the row
    }
    __syncthreads();
    PROF_LAP(7);
    const bool skip = sh.skip != 0;  // the same in every block of the cluster
    if (!skip) {
      unsigned long long* dst = bufs + (cur ^ 1) * slice;
      // rounds of kRound positions, thread t holding r0 + t, r0 +
      // kClusterThreads + t, ...: round warp w of part h is h * 16 + w
      for (int r0 = 0; r0 < count; r0 += kRound) {
        unsigned long long word[H];
        uint32_t d[H];
        int below[H];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int j = r0 + h * kClusterThreads + tid;
          word[h] = j < count ? src[j] : 0;
          d[h] = j < count ? static_cast<uint32_t>((word[h] >> shift) & (kBins - 1)) : kBins;
          const unsigned peers = __match_any_sync(kFull, d[h]);
          below[h] = __popc(peers & ((1u << lane) - 1u));
          if (d[h] < kBins && below[h] == 0) {
            sh.counts[d[h]][h * kClusterWarps + warp] = static_cast<uint8_t>(__popc(peers));
          }
        }
        __syncthreads();
        // offsets: lane l of warp w takes digit 16 w + l / 2 in the first
        // (l even) or second (l odd) half of the round warps, its counts H
        // 8-byte words, which it clears
        {
          const int digit = warp * (kBins / kClusterWarps) + (lane >> 1);
          const int half = (lane & 1) * (kRoundWarps / 2);
          uint2* cell = reinterpret_cast<uint2*>(&sh.counts[digit][half]);
          uint32_t words[2 * H];
#pragma unroll
          for (int i = 0; i < H; ++i) {
            const uint2 packed = cell[i];
            cell[i] = make_uint2(0, 0);
            words[2 * i] = packed.x;
            words[2 * i + 1] = packed.y;
          }
          uint32_t run = 0;
          uint32_t ex[kRoundWarps / 2];
#pragma unroll
          for (int i = 0; i < kRoundWarps / 2; ++i) {
            ex[i] = run;
            run += (words[i >> 2] >> (8 * (i & 3))) & 0xffu;
          }
          const uint32_t first = sh.base[digit];  // read by both lanes before either writes
          const uint32_t other = __shfl_xor_sync(kFull, run, 1);
          const uint32_t before_half = half != 0 ? other : 0;
#pragma unroll
          for (int i = 0; i < kRoundWarps / 2; ++i) {
            sh.offset[digit][half + i] = static_cast<uint16_t>(before_half + ex[i]);
          }
          if (half == 0) sh.round_base[digit] = first;
          if (half != 0) sh.base[digit] = first + other + run;
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if (d[h] < kBins) {
            const uint32_t g = sh.round_base[d[h]] + sh.offset[d[h]][h * kClusterWarps + warp] +
                               static_cast<uint32_t>(below[h]);
            int owner = static_cast<int>(static_cast<float>(g) * inv_slice);
            owner -= static_cast<uint32_t>(owner * slice) > g ? 1 : 0;
            owner += static_cast<uint32_t>((owner + 1) * slice) <= g ? 1 : 0;
            cluster.map_shared_rank(dst, owner)[g - static_cast<uint32_t>(owner * slice)] =
                word[h];
          }
        }
      }
    }
    PROF_LAP(8);
    cluster.sync();  // every word has landed; the counts may be rebuilt
    PROF_LAP(9);
    if (!skip) cur ^= 1;
  }
  PROF_LAP(1);

  // the sorted slice: its order, then this thread's run of it
  const unsigned long long* sorted = bufs + cur * slice;
  for (int j = tid; j < count; j += kClusterThreads) {
    p.order[row_v + lo + j] = static_cast<int>(sorted[j] & 0xffffffffu);
  }
  const int per = (count + kClusterThreads - 1) / kClusterThreads;
  const int b0 = min(tid * per, count);
  const int b1 = min(b0 + per, count);
  float4 total = zero;
  int total_prio = 0;
  for (int j = b0; j < b1; ++j) {
    const Victim x = load_victim(p, row_v + static_cast<int>(sorted[j] & 0xffffffffu));
    if (x.mask) {
      total = add4(total, x.res);
      total_prio += x.prio;
    }
  }
  PROF_LAP(2);
  // runs before this thread's: the slices before, the warps before, the
  // lanes before
  float4 inc = total;
  int inc_prio = total_prio;
  warp_scan(inc, inc_prio, lane, 32);
  if (lane == 31) {
    sh.warp_total[warp] = inc;
    sh.warp_prio[warp] = inc_prio;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < kClusterWarps;
    float4 w_inc = in ? sh.warp_total[lane] : zero;
    int w_prio = in ? sh.warp_prio[lane] : 0;
    warp_scan(w_inc, w_prio, lane, 32);
    const float4 w_ex = make_float4(
        __shfl_up_sync(kFull, w_inc.x, 1), __shfl_up_sync(kFull, w_inc.y, 1),
        __shfl_up_sync(kFull, w_inc.z, 1), __shfl_up_sync(kFull, w_inc.w, 1));
    const int w_ex_prio = __shfl_up_sync(kFull, w_prio, 1);
    if (in) {
      sh.warp_total[lane] = lane == 0 ? zero : w_ex;
      sh.warp_prio[lane] = lane == 0 ? 0 : w_ex_prio;
    }
    if (lane == kClusterWarps - 1) {
      sh.slice_total = w_inc;
      sh.slice_prio = w_prio;
    }
  }
  cluster.sync();  // every slice's totals are in
  if (tid == 0) {
    float4 pre = zero;
    int pre_prio = 0;
    for (int r = 0; r < rank; ++r) {
      pre = add4(pre, *cluster.map_shared_rank(&sh.slice_total, r));
      pre_prio += *cluster.map_shared_rank(&sh.slice_prio, r);
    }
    sh.slice_before = pre;
    sh.prio_before = pre_prio;
  }
  __syncthreads();
  float4 freed = make_float4(__shfl_up_sync(kFull, inc.x, 1), __shfl_up_sync(kFull, inc.y, 1),
                             __shfl_up_sync(kFull, inc.z, 1), __shfl_up_sync(kFull, inc.w, 1));
  int prio = __shfl_up_sync(kFull, inc_prio, 1);
  if (lane == 0) {
    freed = zero;
    prio = 0;
  }
  freed = add4(add4(sh.slice_before, sh.warp_total[warp]), freed);
  prio += sh.prio_before + sh.warp_prio[warp];
  const float4 cap = load4(p.capacity + 4 * static_cast<size_t>(row));
  const float4 used = load4(p.used + 4 * static_cast<size_t>(row));
  for (int j = b0; j < b1; ++j) {
    const Victim x = load_victim(p, row_v + static_cast<int>(sorted[j] & 0xffffffffu));
    if (!x.mask) continue;
    freed = add4(freed, x.res);
    prio += x.prio;
    if (fits(used, cap, ask, freed)) {
      atomicMin(&sh.hit, (static_cast<unsigned long long>(lo + j) << 32) |
                             static_cast<unsigned>(prio));
      break;
    }
  }
  __syncthreads();
  PROF_LAP(3);
  cluster.sync();  // every slice's first fit is in
  if (rank == 0 && tid == 0) {
    unsigned long long hit = kPadWord;
    for (int r = 0; r < cs; ++r) {
      const unsigned long long h = *cluster.map_shared_rank(&sh.hit, r);
      hit = h < hit ? h : hit;
    }
    const bool found = hit != kPadWord;
    write_row(p, row, found && p.eligible[row] != 0,
              found ? static_cast<int>(hit >> 32) : -1,
              static_cast<int>(static_cast<unsigned>(hit & 0xffffffffu)));
  }
  cluster.sync();  // the rank-0 block has read every slice's first fit
  PROF_LAP(4);
  PROF_END();
}

// -- rows past a cluster: a block a row, the words in global scratch ----------

// One block of kGlobalThreads threads sorts and scans row `row`, its `vp`
// sort words at `words`.
__device__ void find_row(const Pass& p, const float4& ask, int vp, unsigned long long* words,
                         int row PROF_PARAM) {
  __shared__ float warp_freed[4][kGlobalThreads / 32];
  __shared__ int warp_prio[kGlobalThreads / 32];
  __shared__ unsigned long long hit;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < vp; i += threads) {
    words[i] = i < p.v ? victim_word(p, ask, row, i) : kPadWord;
  }
  if (tid == 0) hit = kPadWord;
  __syncthreads();
  PROF_LAP(0);
  for (int size = 2; size <= vp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < vp / 2; i += threads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const unsigned long long a = words[lo];
        const unsigned long long b = words[hi];
        if ((a > b) == ascending) {
          words[lo] = b;
          words[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  PROF_LAP(1);

  // this thread's chunk of the sorted row: its total first
  const int per = vp / threads;
  const int base = tid * per;
  const size_t row_v = static_cast<size_t>(row) * p.v;
  float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int total_prio = 0;
  for (int e = 0; e < per; ++e) {
    const int s = base + e;
    if (s >= p.v) break;
    const size_t rv = row_v + static_cast<int>(words[s] & 0xffffffffu);
    if (p.victim_mask[rv]) {
      for (int d = 0; d < 4; ++d) {
        total[d] = __fadd_rn(total[d], p.victim_res[4 * rv + d]);
      }
      total_prio += p.victim_prio[rv];
    }
  }
  PROF_LAP(2);
  // inclusive scan of the chunk totals: in the warp, then over the warps
  float inc[4] = {total[0], total[1], total[2], total[3]};
  int inc_prio = total_prio;
  for (int off = 1; off < 32; off <<= 1) {
    float up[4];
    for (int d = 0; d < 4; ++d) up[d] = __shfl_up_sync(kFull, inc[d], off);
    const int up_prio = __shfl_up_sync(kFull, inc_prio, off);
    if (lane >= off) {
      for (int d = 0; d < 4; ++d) inc[d] = __fadd_rn(inc[d], up[d]);
      inc_prio += up_prio;
    }
  }
  if (lane == 31) {
    for (int d = 0; d < 4; ++d) warp_freed[d][warp] = inc[d];
    warp_prio[warp] = inc_prio;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < threads / 32; ++w) {
      for (int d = 0; d < 4; ++d) {
        warp_freed[d][w] = __fadd_rn(warp_freed[d][w - 1], warp_freed[d][w]);
      }
      warp_prio[w] += warp_prio[w - 1];
    }
  }
  __syncthreads();
  // exclusive prefix of this chunk, then the chunk walked in order
  float4 freed;
  int prio;
  {
    float ex[4];
    for (int d = 0; d < 4; ++d) ex[d] = __shfl_up_sync(kFull, inc[d], 1);
    int ex_prio = __shfl_up_sync(kFull, inc_prio, 1);
    if (lane == 0) {
      for (int d = 0; d < 4; ++d) ex[d] = 0.0f;
      ex_prio = 0;
    }
    float f[4];
    for (int d = 0; d < 4; ++d) {
      f[d] = warp > 0 ? __fadd_rn(warp_freed[d][warp - 1], ex[d]) : ex[d];
    }
    freed = make_float4(f[0], f[1], f[2], f[3]);
    prio = (warp > 0 ? warp_prio[warp - 1] : 0) + ex_prio;
  }
  const float4 cap = load4(p.capacity + 4 * static_cast<size_t>(row));
  const float4 used = load4(p.used + 4 * static_cast<size_t>(row));
  bool hit_here = false;
  for (int e = 0; e < per; ++e) {
    const int s = base + e;
    if (s >= p.v) break;
    const int idx = static_cast<int>(words[s] & 0xffffffffu);
    p.order[row_v + s] = idx;
    const size_t rv = row_v + idx;
    if (hit_here || !p.victim_mask[rv]) continue;
    freed = add4(freed, load4(p.victim_res + 4 * rv));
    prio += p.victim_prio[rv];
    if (fits(used, cap, ask, freed)) {
      atomicMin(&hit, (static_cast<unsigned long long>(s) << 32) |
                          static_cast<unsigned>(prio));
      hit_here = true;
    }
  }
  __syncthreads();
  PROF_LAP(3);
  if (tid == 0) {
    const bool found = hit != kPadWord;
    write_row(p, row, found && p.eligible[row] != 0,
              found ? static_cast<int>(hit >> 32) : -1,
              static_cast<int>(static_cast<unsigned>(hit & 0xffffffffu)));
  }
  __syncthreads();  // `hit` and the words are reused by the block's next row
  PROF_LAP(4);
}

// The resident blocks loop over the rows, each sorting in its own Vp
// words of the global scratch.
__global__ void __launch_bounds__(kGlobalThreads)
find_global_kernel(Pass p, int vp, unsigned long long* scratch) {
  PROF_START();
  unsigned long long* words = scratch + static_cast<size_t>(blockIdx.x) * vp;
  const float4 ask = load_ask(p);
  for (int row = blockIdx.x; row < p.n; row += gridDim.x) {
    find_row(p, ask, vp, words, row PROF_ARG);
  }
  PROF_END();
}

constexpr int kMaxDevices = 64;

// Blocks of the global form: as many as are resident at once, at most
// one a row. The resident count is taken once a device, so that a launch
// captured in a CUDA graph makes no query.
cudaError_t global_grid(int n, int* grid) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int blocks = dev < kMaxDevices ? resident[dev] : 0;
  if (blocks == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, find_global_kernel,
                                                      kGlobalThreads, 0);
    if (e != cudaSuccess) return e;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) resident[dev] = blocks;
  }
  *grid = blocks < n ? blocks : n;
  return cudaSuccess;
}

// Per device, set once by the first plan: the SM count, and the kernels'
// attributes (the warp-a-row form's and the cluster form's opt-in shared
// memory, the cluster form's non-portable sizes).
struct Device {
  cudaError_t error;
  int sms;
};

const Device& device_setup() {
  static Device devices[kMaxDevices] = {};
  static bool done[kMaxDevices] = {};
  static Device failed{cudaErrorInvalidDevice, 0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= kMaxDevices) return failed;
  if (done[dev]) return devices[dev];
  Device out{cudaSuccess, 0};
  e = cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(find_row_warp_kernel<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(row_smem_bytes<16>()));
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(find_row_warp_kernel<32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(row_smem_bytes<32>()));
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(find_cluster_kernel<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cluster_smem_bytes(kClusterSlice)));
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(find_cluster_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cluster_smem_bytes(kWideSlice)));
  }
  for (auto kernel : {find_cluster_kernel<1>, find_cluster_kernel<2>}) {
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
  }
  out.error = e;
  devices[dev] = out;
  done[dev] = true;
  return devices[dev];
}

int padded_width(int v) {
  int vp = 1;
  while (vp < v) vp <<= 1;
  return vp;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The form a pass of N rows of V victims launches, and for the cluster
// form its size and slice.
struct Plan {
  int form;
  int cluster;  // blocks a row (cluster form)
  int asked;    // the size the shape asked for, before the occupancy query
  int slice;    // positions a block holds (cluster form)
};

// Clusters of `s` blocks holding slices of ceil(v / s) positions that can
// be resident at once (cudaOccupancyMaxActiveClusters).
cudaError_t resident_clusters(int v, int s, int* clusters) {
  cudaLaunchAttribute attr;
  const int slice = ceil_div(v, s);
  const cudaLaunchConfig_t cfg =
      cluster_config(1, s, kClusterThreads, cluster_smem_bytes(slice), nullptr, &attr);
  *clusters = 0;
  return cudaOccupancyMaxActiveClusters(
      clusters, round_positions(slice) == 2 ? find_cluster_kernel<2> : find_cluster_kernel<1>,
      &cfg);
}

// The plan a caller asks for: `want` = form << 8 | blocks a row (the
// profile tool times every form at one width); cudaErrorInvalidValue
// where the form cannot take the shape.
cudaError_t wanted_plan(int v, int want, Plan* plan) {
  const int vp = padded_width(v);
  const int form = want >> 8;
  const int s = want & 255;
  *plan = Plan{form, 1, 1, 0};
  switch (form) {
    case kFormWarp:
      return vp <= 32 ? cudaSuccess : cudaErrorInvalidValue;
    case kFormRow:
      return vp > 32 && vp <= kRowWidth ? cudaSuccess : cudaErrorInvalidValue;
    case kFormCluster: {
      if (s < 1 || s > kMaxCluster || (s & (s - 1)) != 0 || ceil_div(v, s) > kClusterSlice) {
        return cudaErrorInvalidValue;
      }
      int clusters = 0;
      const cudaError_t e = resident_clusters(v, s, &clusters);
      if (e != cudaSuccess) return e;
      *plan = Plan{kFormCluster, s, s, ceil_div(v, s)};
      return clusters > 0 ? cudaSuccess : cudaErrorInvalidValue;
    }
    case kFormGlobal:  // a thread's run of the row is vp / kGlobalThreads positions
      return vp >= kGlobalThreads ? cudaSuccess : cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// The cluster size: the fewest blocks whose slices fit in shared memory,
// doubled while N rows leave fewer than two blocks an SM and a slice
// keeps at least a round of kClusterThreads positions, then halved while
// cudaOccupancyMaxActiveClusters says no cluster of that size can be
// resident (`asked` keeps the size before). Rows no cluster's shared
// memory holds, or whose fewest blocks cannot be resident, take the
// global form.
cudaError_t find_plan(int n, int v, int want, Plan* plan) {
  const int vp = padded_width(v);
  *plan = Plan{kFormWarp, 1, 1, 0};
  const Device& dev = device_setup();
  if (dev.error != cudaSuccess) return dev.error;
  if (want >= 0) return wanted_plan(v, want, plan);
  if (vp <= 32) return cudaSuccess;
  if (vp <= kRowWidth) {
    plan->form = kFormRow;
    return cudaSuccess;
  }
  int need = 1;
  while (need <= kMaxCluster && ceil_div(v, need) > kClusterSlice) need <<= 1;
  plan->form = kFormGlobal;
  if (need > kMaxCluster) return cudaSuccess;
  int s = need;
  while (s < kMaxCluster && static_cast<long long>(n) * s < 2LL * dev.sms &&
         ceil_div(v, 2 * s) >= kClusterThreads) {
    s <<= 1;
  }
  plan->asked = s;
  for (; s >= need; s >>= 1) {
    int clusters = 0;
    const cudaError_t e = resident_clusters(v, s, &clusters);
    if (e != cudaSuccess) return e;
    if (clusters > 0) {
      *plan = Plan{kFormCluster, s, plan->asked, ceil_div(v, s)};
      return cudaSuccess;
    }
  }
  plan->asked = need;
  return cudaSuccess;
}

template <int E>
cudaError_t launch_row_form(const Pass& p, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(ceil_div(p.n, kRowWarps));
  find_row_warp_kernel<E><<<blocks, 32 * kRowWarps, row_smem_bytes<E>(), s>>>(p);
  return cudaGetLastError();
}

struct Choose {
  const float* capacity;       // [N, 4]
  const float* used;           // [N, 4]
  const float* ask;            // [4]
  const float* victim_res;     // [N, V, 4]
  const uint8_t* victim_mask;  // [N, V]
  const uint8_t* feasible;     // [N]
  const float* net;            // [N]
  int n;
  int v;
  unsigned long long* scratch;  // [2] best word, finished blocks: zero at launch, left zero
  int32_t* best;               // []
  float* score;                // [N]
};

// What the choice reads of a row besides its victims, loaded before the
// victims are summed so that both loads are in flight together.
struct ChooseRow {
  float2 cap;   // cpu, mem capacity
  float2 used;  // cpu, mem usage
  float net;
  bool feasible;
};

__device__ ChooseRow choose_row(const Choose& c, int row) {
  const size_t r4 = 4 * static_cast<size_t>(row);
  return ChooseRow{*reinterpret_cast<const float2*>(c.capacity + r4),
                   *reinterpret_cast<const float2*>(c.used + r4), c.net[row],
                   c.feasible[row] != 0};
}

// The choice's score of a feasible row once `freed` (every masked victim)
// is released and the ask placed.
__device__ float choose_score(const Choose& c, const ChooseRow& r, const float* freed) {
  const float caps[2] = {r.cap.x, r.cap.y};
  const float used[2] = {r.used.x, r.used.y};
  float pow_sum_terms[2];
  for (int d = 0; d < 2; ++d) {  // cpu, mem drive the fit
    const float cap = caps[d];
    const float proposed = __fadd_rn(__fsub_rn(used[d], freed[d]), c.ask[d]);
    const float ff = cap > 0.0f
        ? __fdiv_rn(__fsub_rn(cap, proposed), fmaxf(cap, 1e-9f))
        : 1.0f;
    pow_sum_terms[d] = expf(__fmul_rn(kLn10, ff));
  }
  const float fit_raw = fminf(
      fmaxf(__fsub_rn(__fsub_rn(20.0f, pow_sum_terms[0]), pow_sum_terms[1]),
            0.0f),
      kMaxScore);
  const float fit = __fdiv_rn(fit_raw, kMaxScore);
  const float penalty = __fdiv_rn(
      1.0f,
      __fadd_rn(1.0f,
                expf(__fdiv_rn(__fsub_rn(r.net, 2048.0f), 256.0f))));
  return __fmul_rn(fit, penalty);
}

// Row `row`'s argmax word (order_key(score) << 32 | ~row), its score
// written.
__device__ unsigned long long choose_word(const Choose& c, int row, const ChooseRow& r,
                                          const float* freed) {
  const float s = r.feasible ? choose_score(c, r, freed) : -INFINITY;
  c.score[row] = s;
  return (static_cast<unsigned long long>(order_key(s)) << 32) |
         (0xffffffffu - static_cast<unsigned>(row));
}

// The block's largest word (each warp's in `warp_best`) into the 64-bit
// atomicMax across blocks; the last block to finish decodes the winner's
// row (the largest score, then the lowest row, whatever the order).
__device__ void choose_argmax(const Choose& c, unsigned long long word,
                              unsigned long long* warp_best) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, word, off);
    word = o > word ? o : word;
  }
  if (lane == 0) warp_best[warp] = word;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kChooseThreads / 32; ++w) {
      word = warp_best[w] > word ? warp_best[w] : word;
    }
    atomicMax(&c.scratch[0], word);
    __threadfence();
    const unsigned long long done = atomicAdd(&c.scratch[1], 1ULL);
    if (done == gridDim.x - 1) {
      // every block's maximum has landed: decode the winner's row, and
      // leave the scratch zero for the next launch on this stream
      __threadfence();
      const unsigned long long won = __ldcg(&c.scratch[0]);
      *c.best = static_cast<int32_t>(0xffffffffu -
                                     static_cast<unsigned>(won & 0xffffffffu));
      __stcg(&c.scratch[0], 0ULL);  // every block is done with both words
      __stcg(&c.scratch[1], 0ULL);
    }
  }
}

// V <= 32: a warp holds 32 / vp rows (vp the next power of two of V),
// lane l victim l % vp of row l / vp; the warps loop over the rows. With
// kFind the warp first runs the find pass on its rows (find_warp_pass,
// writing `p`'s outputs) and scores them on the feasible and net it
// returns; without, it reads them from the pass's outputs in `c`.
template <bool kFind>
__global__ void __launch_bounds__(kChooseThreads)
choose_kernel(Choose c, Pass p, int vp) {
  __shared__ unsigned long long warp_best[kChooseThreads / 32];
  PROF_START();
  const int lane = threadIdx.x & 31;
  const int i = lane % vp;
  const long long rows_per_warp = 32 / vp;
  const long long warps = static_cast<long long>(gridDim.x) * (kChooseThreads / 32);
  const float4 ask = kFind ? load_ask(p) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  unsigned long long word = 0;
  for (long long first = (static_cast<long long>(blockIdx.x) * (kChooseThreads / 32) +
                          (threadIdx.x >> 5)) * rows_per_warp;
       first < c.n; first += warps * rows_per_warp) {
    const long long wide_row = first + lane / vp;
    const bool in = wide_row < c.n && i < c.v;
    ChooseRow row_in{};
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kFind) {
      Victim x{r, 0, false};
      if (in) x = load_victim(p, static_cast<size_t>(wide_row) * c.v + i);
      const int row = wide_row < c.n ? static_cast<int>(wide_row) : c.n;
      const RowFit fit = find_warp_pass(p, ask, vp, row, x PROF_ARG);
      if (i == 0 && wide_row < c.n) {
        const size_t r4 = 4 * static_cast<size_t>(row);
        row_in = ChooseRow{*reinterpret_cast<const float2*>(c.capacity + r4),
                           *reinterpret_cast<const float2*>(c.used + r4), fit.net,
                           fit.feasible};
      }
      r = x.mask ? x.res : r;
    } else {
      if (i == 0 && wide_row < c.n) row_in = choose_row(c, static_cast<int>(wide_row));
      if (in) {
        const size_t rv = static_cast<size_t>(wide_row) * c.v + i;
        const float4 x = *reinterpret_cast<const float4*>(c.victim_res + 4 * rv);
        const bool masked = c.victim_mask[rv] != 0;
        r = masked ? x : r;
      }
    }
    for (int off = vp >> 1; off > 0; off >>= 1) {
      r.x = __fadd_rn(r.x, __shfl_xor_sync(kFull, r.x, off));
      r.y = __fadd_rn(r.y, __shfl_xor_sync(kFull, r.y, off));
      r.z = __fadd_rn(r.z, __shfl_xor_sync(kFull, r.z, off));
      r.w = __fadd_rn(r.w, __shfl_xor_sync(kFull, r.w, off));
    }
    if (i == 0 && wide_row < c.n) {
      const float freed[4] = {r.x, r.y, r.z, r.w};
      const unsigned long long w = choose_word(c, static_cast<int>(wide_row), row_in, freed);
      word = w > word ? w : word;
    }
  }
  PROF_LAP(5);
  choose_argmax(c, word, warp_best);
  PROF_END();
}

// V > 32: one warp a node; each lane adds every 32nd victim, then a
// butterfly of shuffles adds the lanes' sums (the same on every lane).
__global__ void __launch_bounds__(kChooseThreads)
choose_wide_kernel(Choose c) {
  __shared__ unsigned long long warp_best[kChooseThreads / 32];
  const int lane = threadIdx.x & 31;
  const long long wide_row =
      static_cast<long long>(blockIdx.x) * (kChooseThreads / 32) + (threadIdx.x >> 5);
  const bool in = wide_row < c.n;
  const int row = in ? static_cast<int>(wide_row) : 0;
  ChooseRow row_in{};
  if (in && lane == 0) row_in = choose_row(c, row);
  float freed[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (in) {
    const size_t row_v = static_cast<size_t>(row) * c.v;
    for (int i = lane; i < c.v; i += 32) {
      if (c.victim_mask[row_v + i]) {
        const float4 r = *reinterpret_cast<const float4*>(c.victim_res + 4 * (row_v + i));
        freed[0] = __fadd_rn(freed[0], r.x);
        freed[1] = __fadd_rn(freed[1], r.y);
        freed[2] = __fadd_rn(freed[2], r.z);
        freed[3] = __fadd_rn(freed[3], r.w);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    for (int d = 0; d < 4; ++d) {
      freed[d] = __fadd_rn(freed[d], __shfl_xor_sync(kFull, freed[d], off));
    }
  }
  unsigned long long word = 0;
  if (in && lane == 0) word = choose_word(c, row, row_in, freed);
  choose_argmax(c, word, warp_best);
}

// Blocks of the warp-form choice: `blocks`, at most as many as are
// resident at once (the warps loop over the rows beyond), so that the
// cross-block argmax takes one atomic pair a block. The SM count is
// taken once a device, so that a captured launch makes no query.
cudaError_t choose_grid(long long blocks, int* grid) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int most = dev < kMaxDevices ? resident[dev] : 0;
  if (most == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    most = sms * (2048 / kChooseThreads);
    if (dev < kMaxDevices) resident[dev] = most;
  }
  *grid = static_cast<int>(blocks < most ? blocks : most);
  return cudaSuccess;
}

// The warp-form choice's launch (V <= 32), with or without the find pass.
template <bool kFind>
cudaError_t launch_choose_warp(const Choose& c, const Pass& p, cudaStream_t s) {
  const int vp = padded_width(c.v);
  const long long warps = (static_cast<long long>(c.n) + 32 / vp - 1) / (32 / vp);
  const long long blocks = (warps + kChooseThreads / 32 - 1) / (kChooseThreads / 32);
  int grid = 0;
  const cudaError_t e = choose_grid(blocks, &grid);
  if (e != cudaSuccess) return e;
  choose_kernel<kFind><<<static_cast<unsigned>(grid), kChooseThreads, 0, s>>>(c, p, vp);
  return cudaGetLastError();
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// C entry points, bound with ctypes (nomad_tpu_torch/device/preempt.py).
// Each launches on `stream`, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported to the caller. The
// victims' records and the nodes' capacity and usage rows are read as
// 16-byte float4s: each array must start on 16 bytes.

// 64-bit words of the scratch `nomad_find_preemption` takes for N rows of
// V victims in the form `want` asks for (-1: the plan's; 0 unless the
// global form runs); a negative cudaError on failure.
extern "C" long long nomad_find_preemption_scratch_words(int n, int v, int want) {
  if (n < 1 || v < 1 || v > kMaxVictimWidth) {
    return -static_cast<long long>(cudaErrorInvalidValue);
  }
  Plan plan;
  cudaError_t e = find_plan(n, v, want, &plan);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  if (plan.form != kFormGlobal) return 0;
  int grid = 0;
  e = global_grid(n, &grid);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(grid) * padded_width(v);
}

// `scratch` holds nomad_find_preemption_scratch_words(n, v, want) words
// (none needed, and it may be null, unless the global form runs). `want`
// asks for a form (form << 8 | blocks a row; -1: find_plan's choice).
// `launched` receives the form launched (0 warp, 1 warp a row, 2
// cluster, 3 global), the cluster's blocks a row, and the size the shape
// asked for.
extern "C" int nomad_find_preemption(
    const float* capacity, const float* used, const float* ask,
    const uint8_t* eligible, const float* victim_res,
    const int32_t* victim_prio, const uint8_t* victim_mask, int n, int v,
    uint8_t* feasible, int32_t* k, float* net, int32_t* order,
    unsigned long long* scratch, int want, int* launched, void* stream) {
  if (n < 1 || v < 1 || v > kMaxVictimWidth || !aligned16(capacity) || !aligned16(used) ||
      !aligned16(victim_res)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pass p{capacity, used,  ask,  eligible, victim_res, victim_prio,
               victim_mask, n, v,  feasible, k,          net,
               order};
  Plan plan;
  cudaError_t e = find_plan(n, v, want, &plan);
  if (e != cudaSuccess) return static_cast<int>(e);
  launched[0] = plan.form;
  launched[1] = plan.cluster;
  launched[2] = plan.asked;
  const int vp = padded_width(v);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan.form) {
    case kFormWarp: {
      const long long warps = (static_cast<long long>(n) + 32 / vp - 1) / (32 / vp);
      const long long blocks = (warps * 32 + kWarpThreads - 1) / kWarpThreads;
      find_warp_kernel<<<static_cast<unsigned>(blocks), kWarpThreads, 0, s>>>(p, vp);
      return static_cast<int>(cudaGetLastError());
    }
    case kFormRow:
      switch (vp) {
        case 64: return static_cast<int>(launch_row_form<2>(p, s));
        case 128: return static_cast<int>(launch_row_form<4>(p, s));
        case 256: return static_cast<int>(launch_row_form<8>(p, s));
        case 512: return static_cast<int>(launch_row_form<16>(p, s));
        default: return static_cast<int>(launch_row_form<32>(p, s));
      }
    case kFormCluster:
      return static_cast<int>(launch_cluster(round_positions(plan.slice) == 2
                                                 ? find_cluster_kernel<2>
                                                 : find_cluster_kernel<1>,
                                             n, plan.cluster,
                                             kClusterThreads,
                                             cluster_smem_bytes(plan.slice), s, p,
                                             plan.slice));
    default: {
      if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      int grid = 0;
      e = global_grid(n, &grid);
      if (e != cudaSuccess) return static_cast<int>(e);
      find_global_kernel<<<grid, kGlobalThreads, 0, s>>>(p, vp, scratch);
      return static_cast<int>(cudaGetLastError());
    }
  }
}

// The choice on the find pass's outputs `feasible` and `net`.
extern "C" int nomad_choose_preemption_node(
    const float* capacity, const float* used, const float* ask,
    const float* victim_res, const uint8_t* victim_mask,
    const uint8_t* feasible, const float* net, int n, int v,
    unsigned long long* scratch, int32_t* best, float* score, void* stream) {
  if (n < 1 || v < 1 || !aligned16(victim_res)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Choose c{capacity, used, ask,     victim_res, victim_mask, feasible,
                 net,      n,    v,       scratch,    best,        score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= 32) return static_cast<int>(launch_choose_warp<false>(c, Pass{}, s));
  const int rows = kChooseThreads / 32;
  const long long blocks = (static_cast<long long>(n) + rows - 1) / rows;
  choose_wide_kernel<<<static_cast<unsigned>(blocks), kChooseThreads, 0, s>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// V <= 32: the find pass and the choice in one launch (one kernel node):
// the find pass's outputs as nomad_find_preemption writes them, and the
// choice's as nomad_choose_preemption_node does.
extern "C" int nomad_find_choose_preemption(
    const float* capacity, const float* used, const float* ask,
    const uint8_t* eligible, const float* victim_res,
    const int32_t* victim_prio, const uint8_t* victim_mask, int n, int v,
    uint8_t* feasible, int32_t* k, float* net, int32_t* order,
    unsigned long long* scratch, int32_t* best, float* score, void* stream) {
  if (n < 1 || v < 1 || v > 32 || !aligned16(capacity) || !aligned16(used) ||
      !aligned16(victim_res)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pass p{capacity, used,  ask,  eligible, victim_res, victim_prio,
               victim_mask, n, v,  feasible, k,          net,
               order};
  const Choose c{capacity, used, ask,     victim_res, victim_mask, feasible,
                 net,      n,    v,       scratch,    best,        score};
  return static_cast<int>(launch_choose_warp<true>(c, p, static_cast<cudaStream_t>(stream)));
}
