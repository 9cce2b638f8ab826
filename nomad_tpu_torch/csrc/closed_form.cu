// Closed-form greedy placement on Hopper (sm_90a).
//
// Replaces nomad_tpu/device/score.py:place_closed_form_kernel. For each
// group lane g it scores every candidate "the (j+1)-th instance of the
// lane's ask on node n" (the reference _score_planes: 10^x binpack or
// spread fit over cpu/mem, job anti-affinity, reschedule penalty, node
// affinity, slot caps, optional jitter), clamps each node's column by a
// running minimum along j, and takes the top k of the node-major [N*J]
// plane ordered by (value desc, index asc) -- exactly lax.top_k's order.
// It returns the node row and the unclamped score of each pick; picks
// whose clamped score is -inf become row -1 / score -inf.
//
// What bounds it on the H100: reading its inputs, 14 bytes per (g, n)
// shared by the J candidates of the node -- the arithmetic (two IEEE
// expf and five IEEE divisions per feasible candidate) is smaller once
// only the candidates that can be picks are scored. At the headline shape
// (128 lanes x 16,384 nodes x J 80) the plane has 168 M candidates, ~9 %
// of them feasible (every column ends at its feasible-column bound) and
// far fewer near the top k. What the one-block form takes instead is
// latency: a lane's 16,384 nodes on one SM, scored one after another by
// each thread, six times (PERF.md: nine tenths of a G 1 launch). So a
// lane runs over a thread-block cluster where the lanes leave SMs idle.
//
// Both forms share the selection, and no plane lives in device memory:
//  - a node's column is walked by recomputing its clamped scores as
//    order-preserving u32 keys; the -inf tail past the node's
//    feasible-column bound is counted, never walked;
//  - a floor first: the k-th largest column head (j = 0), found by radix
//    select over the N heads. At least k keys lie at or above it, so no
//    key below it is a pick, and since the clamp makes every column
//    non-increasing, each later walk stops at the first key under the
//    floor -- most columns after one candidate;
//  - radix select of the k-th largest key (the threshold) over 11/11/10
//    bit digits, one floored walk per digit;
//  - the keys above the threshold are picks; of the keys equal to it the
//    lowest indices (n*J + j) are, as in lax.top_k; each pick reports the
//    unclamped score of its (n, j).
//
// One-block form (closed_form_kernel, a 512-thread block a lane; where a
// cluster block's share does not fit in shared memory): each digit walks
// all N nodes; a compaction walk gives keys above the threshold slots in
// any order and ranks the ties by a block-wide scan over the nodes of
// each round; a bitonic sort of the k (key, ~index) words -- in shared
// memory up to 4,096 slots, in the lane's scratch beyond -- and the
// unclamped score recomputed for each pick.
//
// Cluster form (closed_form_cluster_kernel, a lane over S = 2..16 blocks
// of one cluster; S by the lane count, nomad_closed_form_cluster): block
// r takes the contiguous node slice [r * slice, (r + 1) * slice), so
// index order is (slice, local index) and a tie rank is a prefix over
// slices.
//  - Each block scores its slice's nodes once and stages, a node, the
//    unclamped scores of its first two columns and its feasible-column
//    bound in shared memory (both columns' loads in flight together).
//    Where all the lanes' clusters stay resident with the larger share
//    (cudaOccupancyMaxActiveClusters), the block also keeps the scores
//    of columns 2 to cached - 1 (at most 5) there once a walk has
//    computed them (the node's own thread walks it in every phase; at
//    cached = kStaged it keeps none). The head histograms read the
//    stage, and every walk starts from it: most walks end by column 1
//    (the clamp and the anti-affinity term), a deeper one scores its
//    kept columns once in the launch, and feasible_columns is never
//    called again.
//  - A digit: each block's histogram (warp-aggregated shared atomics) and
//    its sums over groups of 32 bins, one cluster barrier, then warp 0 of
//    every block sums the S blocks' group sums through distributed shared
//    memory to find the group, and that group's 32 bins to find the digit
//    -- the same one in every block. Histograms are double-buffered, so a
//    block never clears one another may still read.
//  - One walk counts each node's keys above the threshold (a prefix of
//    its column: j < above) and equal to it (the next `equal`), and
//    writes the words above it, with their unclamped scores, to the
//    block's part of the lane scratch. The blocks' two counts cross the
//    cluster at one barrier (the last read of another block's shared
//    memory: each block arrives on the exit barrier there); block r's
//    ties are taken from the tie rank of the slices before it on, the
//    need lowest across the cluster, and go straight to their output
//    slots (a tie's place is the words above the threshold plus its
//    rank), the node of each found by a binary search over the block's
//    prefix of the equal counts.
//  - The words above the threshold are ranked: every block reads all of
//    them into shared memory and places a 1/S chunk, each word's place
//    the count of words above it (words are unique: the index is in
//    them), counted by several threads a word where the chunk is small;
//    a word's unclamped score comes from the scratch.
//  - Ties at -inf (fewer feasible keys than k) are all row -1 / -inf
//    whatever their order, so they are written without a search.
//
// Numerics: the per-candidate arithmetic is candidate.cuh's (IEEE
// division, expf, no FMA contraction), shared with the coupled kernels.
// The unclamped score of a pick above -inf is num / den of its (n, j)
// (it fits), the same operations in either form and in the plain version.

#include <cooperative_groups.h>

#include <initializer_list>

#include "candidate.cuh"
#include "cluster.cuh"

// Phase clocks for tools/closed_form_profile.py, compiled in only with
// -DNOMAD_CLOSED_FORM_PROFILE: thread 0 of each of the first 16 blocks
// adds the clock64 cycles since its last lap to its slot i (its waits at
// barriers included, so a phase's count is its block's), and block 0
// counts the launches in slot 15; PROF_CLUSTER_SYNC adds a cluster
// barrier only there, so that the next lap shows the slowest block.
#ifdef NOMAD_CLOSED_FORM_PROFILE
__device__ long long g_prof[16][16];
#define PROF_START() long long prof_t = clock64()
#define PROF_LAP(i)                                          \
  do {                                                       \
    if (blockIdx.x < 16 && threadIdx.x == 0) {               \
      const long long prof_now = clock64();                  \
      g_prof[blockIdx.x][i] += prof_now - prof_t;            \
      prof_t = prof_now;                                     \
    }                                                        \
  } while (0)
#define PROF_BARRIER() __syncthreads()
#define PROF_CLUSTER_SYNC(cluster) (cluster).sync()
#define PROF_END()                                           \
  do {                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_prof[0][15] += 1; \
  } while (0)
extern "C" int nomad_closed_form_profile(long long* host, int reset) {
  if (reset) {
    static const long long zero[16][16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));
}
#else
#define PROF_START()
#define PROF_LAP(i)
#define PROF_BARRIER()
#define PROF_CLUSTER_SYNC(cluster)
#define PROF_END()
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;          // 11-bit radix digits
constexpr int kSmemSortMax = 4096;   // top-k slots sorted in shared memory
constexpr int kMaxCluster = 16;      // blocks a lane (a non-portable cluster size)
constexpr int kGroup = 32;           // bins a group sum covers (cluster digits)
constexpr int kGroups = kBins / kGroup;
constexpr int kStaged = 2;           // columns a cluster block scores a node up front
constexpr int kMaxCached = 6;        // columns whose scores it keeps at most, a node
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long compose(uint32_t key, uint32_t idx) {
  // descending order of this word = key desc, then index asc
  return (static_cast<unsigned long long>(key) << 32) | (0xffffffffu - idx);
}

// Scanning bins from the top, find the bin holding the rem-th largest
// key; leaves the bin in *digit and rem minus the count above it in *left.
__device__ void select_digit(const uint32_t* hist, int nbins, uint32_t rem,
                             uint32_t* digit, uint32_t* left) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = nbins / 32;
    const int hi = nbins - lane * per;  // lane 0 owns the top bins
    uint32_t sum = 0;
    for (int b = hi - 1; b >= hi - per; --b) sum += hist[b];
    uint32_t incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const uint32_t excl = incl - sum;
    const unsigned hit = __ballot_sync(0xffffffffu, excl < rem && rem <= incl);
    if (lane == __ffs(hit) - 1) {
      uint32_t cum = excl;
      for (int b = hi - 1; b >= hi - per; --b) {
        if (cum + hist[b] >= rem) {
          *digit = static_cast<uint32_t>(b);
          *left = rem - cum;
          break;
        }
        cum += hist[b];
      }
    }
  }
  __syncthreads();
}

// Walk node n's column of lane g over j < len: call f(j, key) with the
// running-min clamped key, in j order, while the key is at least
// `floor`. The clamp makes a column's keys non-increasing, so the walk
// stops at the first key below `floor`. Returns the j where it stopped:
// with floor = key(-inf) that is the first infeasible j (it and every
// later j hold key(-inf)), or len.
template <class F>
__device__ int walk_column(const Inputs& in, int g, int n, int len,
                           uint32_t floor, F&& f) {
  const float jmax = feasible_columns(in, g, n);
  float run = INFINITY;
  int j = 0;
  for (; j < len; ++j) {
    const float s = raw_score(in, g, n, j, jmax);
    if (s == -INFINITY) break;
    run = fminf(run, s);
    const uint32_t key = order_key(run);
    if (key < floor) break;
    f(j, key);
  }
  return j;
}

// Histogram of the `width` bits at `shift` of the lane's keys at or above
// `floor` (columns j < len) whose bits from `shift + width` up equal
// `prefix` (no test when shift + width = 32). Run-length aggregated, so
// a thread issues one shared atomic per run of equal bins.
__device__ void lane_histogram(const Inputs& in, int g, uint32_t* hist, int len,
                               uint32_t floor, int width, int shift,
                               uint32_t prefix) {
  const int nbins = 1 << width;
  const int high = shift + width;
  for (int b = threadIdx.x; b < nbins; b += kThreads) hist[b] = 0;
  __syncthreads();
  const uint32_t ninf_key = order_key(-INFINITY);
  const auto match = [&](uint32_t key) {
    return high >= 32 || (key >> high) == prefix;
  };
  const auto bin_of = [&](uint32_t key) {
    return (key >> shift) & static_cast<uint32_t>(nbins - 1);
  };
  uint32_t run_bin = 0, run_cnt = 0;
  const auto add = [&](uint32_t bin, uint32_t cnt) {
    if (run_cnt != 0 && bin != run_bin) {
      atomicAdd(&hist[run_bin], run_cnt);
      run_cnt = 0;
    }
    run_bin = bin;
    run_cnt += cnt;
  };
  for (int n = threadIdx.x; n < in.n; n += kThreads) {
    const int jcut = walk_column(in, g, n, len, floor, [&](int, uint32_t key) {
      if (match(key)) add(bin_of(key), 1);
    });
    if (floor == ninf_key && jcut < len && match(ninf_key)) {
      add(bin_of(ninf_key), static_cast<uint32_t>(len - jcut));
    }
  }
  if (run_cnt != 0) atomicAdd(&hist[run_bin], run_cnt);
  __syncthreads();
}

// Inclusive prefix sum of v over the warp.
__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The rank-th largest (1-based) of the lane's keys at or above `floor`
// over columns j < len, by radix select on 11/11/10-bit digits. *left
// receives how many keys equal to it are among the top `rank`.
__device__ uint32_t select_key(const Inputs& in, int g, uint32_t* hist, int len,
                               uint32_t floor, uint32_t rank,
                               uint32_t* s_digit, uint32_t* s_left,
                               uint32_t* left) {
  lane_histogram(in, g, hist, len, floor, 11, 21, 0);
  select_digit(hist, kBins, rank, s_digit, s_left);
  const uint32_t d1 = *s_digit;
  lane_histogram(in, g, hist, len, floor, 11, 10, d1);
  select_digit(hist, kBins, *s_left, s_digit, s_left);
  const uint32_t d12 = (d1 << 11) | *s_digit;
  lane_histogram(in, g, hist, len, floor, 10, 0, d12);
  select_digit(hist, kBins / 2, *s_left, s_digit, s_left);
  *left = *s_left;
  return (d12 << 10) | *s_digit;
}

__global__ void __launch_bounds__(kThreads)
closed_form_kernel(Inputs in, int k, int k_eff, int kpad,
                   unsigned long long* cand, int32_t* out_choices,
                   float* out_scores) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t s_digit, s_left, s_gt, s_eq, s_done;
  extern __shared__ unsigned long long sort_buf[];

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int J = in.j;
  unsigned long long* lane_cand = cand + static_cast<size_t>(g) * kpad;
  const uint32_t ninf_key = order_key(-INFINITY);
  PROF_START();

  // (a) a floor under the picks: the k_eff-th largest column head. The
  // k_eff columns whose heads reach it hold k_eff keys at or above it,
  // so no key below it is a pick, and every later walk stops there.
  uint32_t need = 0;
  uint32_t floor = ninf_key;
  if (in.n >= k_eff) {
    floor = select_key(in, g, hist, 1, ninf_key, static_cast<uint32_t>(k_eff),
                       &s_digit, &s_left, &need);
  }
  PROF_LAP(0);
  // (b) the k_eff-th largest key, and how many keys equal to it to take
  const uint32_t thresh = select_key(in, g, hist, J, floor,
                                     static_cast<uint32_t>(k_eff), &s_digit,
                                     &s_left, &need);
  const uint32_t n_gt = static_cast<uint32_t>(k_eff) - need;
  PROF_LAP(1);

  // (c) compaction: all keys above thresh, and the `need` lowest-index
  // keys equal to it. A round gives each thread one node; the nodes of a
  // round, and the j of a column, are in index order.
  if (tid == 0) {
    s_gt = 0;
    s_eq = 0;
    s_done = 0;
  }
  __syncthreads();
  for (int base = 0; base < in.n; base += kThreads) {
    const int n = base + tid;
    uint32_t my_eq = 0;
    int jcut = J;
    if (n < in.n) {
      jcut = walk_column(in, g, n, J, thresh, [&](int j, uint32_t key) {
        if (key > thresh) {
          const uint32_t slot = atomicAdd(&s_gt, 1u);
          lane_cand[slot] = compose(key, static_cast<uint32_t>(n) * J + j);
        } else if (key == thresh) {
          ++my_eq;
        }
      });
      if (ninf_key == thresh) my_eq += static_cast<uint32_t>(J - jcut);
    }
    const uint32_t incl = warp_inclusive(my_eq);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
      const uint32_t wi = warp_inclusive(w);
      if (lane < kWarps) warp_sums[lane] = wi - w;
    }
    __syncthreads();
    uint32_t rank = s_eq + warp_sums[warp] + (incl - my_eq);
    if (my_eq != 0 && rank < need) {
      // walk the column again to place this node's ties in j order
      uint32_t r = rank;
      const int cut = walk_column(in, g, n, J, thresh, [&](int j, uint32_t key) {
        if (key == thresh) {
          if (r < need) lane_cand[n_gt + r] = compose(thresh, static_cast<uint32_t>(n) * J + j);
          ++r;
        }
      });
      if (ninf_key == thresh) {
        for (int j = cut; j < J && r < need; ++j, ++r) {
          lane_cand[n_gt + r] = compose(thresh, static_cast<uint32_t>(n) * J + j);
        }
      }
    }
    rank += my_eq;
    __syncthreads();
    if (tid == kThreads - 1) {
      s_eq = rank;
      s_done = (s_gt == n_gt && s_eq >= need) ? 1u : 0u;
    }
    __syncthreads();
    if (s_done) break;
  }

  PROF_LAP(2);
  // (d) sort the k_eff picks: (key desc, index asc)
  unsigned long long* buf = kpad <= kSmemSortMax ? sort_buf : lane_cand;
  for (int i = tid; i < kpad; i += kThreads) {
    buf[i] = i < k_eff ? lane_cand[i] : 0ull;
  }
  __syncthreads();
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < kpad / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = buf[lo];
        const unsigned long long b = buf[hi];
        if ((a < b) == desc) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  PROF_LAP(3);
  for (int i = tid; i < k; i += kThreads) {
    int32_t choice = -1;
    float score = -INFINITY;
    if (i < k_eff) {
      const unsigned long long c = buf[i];
      const uint32_t key = static_cast<uint32_t>(c >> 32);
      const uint32_t idx = 0xffffffffu - static_cast<uint32_t>(c);
      if (key_value(key) > -INFINITY) {
        const int n = static_cast<int>(idx / static_cast<uint32_t>(J));
        const int j = static_cast<int>(idx % static_cast<uint32_t>(J));
        choice = n;
        score = raw_score(in, g, n, j, feasible_columns(in, g, n));
      }
    }
    out_choices[static_cast<size_t>(g) * k + i] = choice;
    out_scores[static_cast<size_t>(g) * k + i] = score;
  }
  PROF_BARRIER();
  PROF_LAP(4);
  PROF_END();
}


// -- cluster form ------------------------------------------------------------

// A node's head, staged once: the unclamped scores of its first two
// columns (-inf past its feasible-column bound) and the bound; both
// columns' candidate_terms are independent of the bound, so their loads
// are in flight together.
struct Staged {
  float raw0;
  float raw1;
  float jmax;
};

__device__ Staged stage_node(const Inputs& in, int g, int n) {
  const float jmax = feasible_columns(in, g, n);
  float num0, den0, num1 = 0.0f, den1 = 1.0f;
  candidate_terms(in, g, n, 0, &num0, &den0);
  if (in.j > 1) candidate_terms(in, g, n, 1, &num1, &den1);
  const float raw0 = 0.0f < jmax ? __fdiv_rn(num0, den0) : -INFINITY;
  const float raw1 = in.j > 1 && 1.0f < jmax ? __fdiv_rn(num1, den1) : -INFINITY;
  return Staged{raw0, raw1, jmax};
}

// walk_column from a staged head: columns 0 and 1 come from the stage;
// a later column below `cached` is scored the first time a walk reaches
// it and kept in `col` (stride `stride` a column; only the node's own
// thread walks it, in every phase), and every other column is scored
// each time. `f(j, key, raw)` also gets the unclamped score.
template <class F>
__device__ int walk_staged(const Inputs& in, int g, int n, const Staged& st, float* col,
                           int stride, int cached, int len, uint32_t floor, F&& f) {
  if (st.raw0 == -INFINITY) return 0;
  float run = st.raw0;
  uint32_t key = order_key(run);
  if (key < floor) return 0;
  f(0, key, st.raw0);
  if (len < 2 || st.raw1 == -INFINITY) return 1;
  run = fminf(run, st.raw1);
  key = order_key(run);
  if (key < floor) return 1;
  f(1, key, st.raw1);
  int j = 2;
  for (; j < len; ++j) {
    float s;
    if (j < cached) {
      s = col[j * stride];
      if (isnan(s)) {
        s = raw_score(in, g, n, j, st.jmax);
        col[j * stride] = s;
      }
    } else {
      s = raw_score(in, g, n, j, st.jmax);
    }
    if (s == -INFINITY) break;
    run = fminf(run, s);
    key = order_key(run);
    if (key < floor) break;
    f(j, key, s);
  }
  return j;
}

// Adds cnt to hist[bin] for every lane with `has`: one shared atomic per
// distinct bin of the warp. Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(uint32_t* hist, bool has, uint32_t bin,
                                         uint32_t cnt) {
  const unsigned peers = __match_any_sync(kFull, has ? bin : kFull);
  if (!has) return;
  const uint32_t sum = __reduce_add_sync(peers, cnt);
  if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], sum);
}

// Group sums of a built histogram (kGroup bins each), for the cluster's
// two-step digit search. nbins / 4 <= kThreads: a thread adds 4 bins.
__device__ void group_sums(const uint32_t* hist, uint32_t* groups, int nbins) {
  const int q = threadIdx.x;
  if (q < nbins / 4) {
    const uint4 v = reinterpret_cast<const uint4*>(hist)[q];
    uint32_t sum = v.x + v.y + v.z + v.w;
    for (int o = 1; o < kGroup / 4; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
    if ((q & (kGroup / 4 - 1)) == 0) groups[q / (kGroup / 4)] = sum;
  }
}

// p[ia] and p[ib] summed over the S blocks of the cluster (distributed
// shared memory), each block starting at its own rank so that no block's
// memory serves the whole cluster at once. S is a compile-time constant
// here, so the 2 S loads are issued together.
template <int S>
__device__ uint2 cluster_sum2(cooperative_groups::cluster_group& cluster, const uint32_t* p,
                              int ia, int ib, int rank) {
  uint32_t va[S], vb[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const uint32_t* q = cluster.map_shared_rank(p, (rank + r) & (S - 1));
    va[r] = q[ia];
    vb[r] = q[ib];
  }
  uint2 sum = make_uint2(0u, 0u);
#pragma unroll
  for (int r = 0; r < S; ++r) {
    sum.x += va[r];
    sum.y += vb[r];
  }
  return sum;
}

__device__ uint2 cluster_sum2(cooperative_groups::cluster_group& cluster, const uint32_t* p,
                              int ia, int ib) {
  const int rank = static_cast<int>(cluster.block_rank());
  switch (cluster.num_blocks()) {
    case 2:
      return cluster_sum2<2>(cluster, p, ia, ib, rank);
    case 4:
      return cluster_sum2<4>(cluster, p, ia, ib, rank);
    case 8:
      return cluster_sum2<8>(cluster, p, ia, ib, rank);
    default:
      return cluster_sum2<16>(cluster, p, ia, ib, rank);
  }
}

// One digit of a selection across the cluster: every block has built its
// histogram `hist` and its group sums `groups`. After one cluster barrier
// warp 0 of every block sums the S blocks' group sums, finds the group
// holding the rem-th largest key, then sums that group's 32 bins over the
// blocks and finds the digit -- the same one in every block.
__device__ void cluster_digit(cooperative_groups::cluster_group& cluster,
                              const uint32_t* hist, const uint32_t* groups, int nbins,
                              uint32_t rem, uint32_t* s_digit, uint32_t* s_left) {
  cluster.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int ngroups = nbins / kGroup;
    const int per = ngroups / 32;  // groups a lane, lane 0 the top ones
    const int top = ngroups - 1 - lane * per;
    const uint2 two = cluster_sum2(cluster, groups, top, per == 2 ? top - 1 : top);
    const uint32_t hi = two.x;
    const uint32_t lo = per == 2 ? two.y : 0u;  // the lane's lower group
    const uint32_t sum = hi + lo;
    const uint32_t incl = warp_inclusive(sum);
    const uint32_t excl = incl - sum;
    const int src = __ffs(__ballot_sync(kFull, excl < rem && rem <= incl)) - 1;
    int group = top;
    uint32_t above = excl;
    if (per == 2 && excl + hi < rem) {
      group = top - 1;
      above = excl + hi;
    }
    group = __shfl_sync(kFull, group, src);
    above = __shfl_sync(kFull, above, src);
    const int bin = group * kGroup + kGroup - 1 - lane;  // lane 0 the group's top bin
    const uint32_t cnt = cluster_sum2(cluster, hist, bin, bin).x;
    const uint32_t want = rem - above;
    const uint32_t bin_incl = warp_inclusive(cnt);
    const uint32_t bin_excl = bin_incl - cnt;
    if (bin_excl < want && want <= bin_incl) {
      *s_digit = static_cast<uint32_t>(bin);
      *s_left = want - bin_excl;
    }
  }
  __syncthreads();
}

// The rank-th largest key over the cluster by 11/11/10-bit digits;
// build(hist, width, shift, prefix) adds to the block's zeroed histogram
// the keys whose bits above shift + width equal prefix. Histograms and
// group sums alternate between two buffers (*par is the next one), so a
// block never clears what another may still read.
template <class Build>
__device__ uint32_t cluster_select(cooperative_groups::cluster_group& cluster,
                                   uint32_t* hist, uint32_t* groups, int* par, uint32_t rank,
                                   uint32_t* s_digit, uint32_t* s_left, uint32_t* left,
                                   Build&& build) {
  uint32_t prefix = 0;
  uint32_t rem = rank;
  const int widths[3] = {11, 11, 10};
  int shift = 32;
  for (int d = 0; d < 3; ++d) {
    const int width = widths[d];
    shift -= width;
    uint32_t* h = hist + *par * kBins;
    uint32_t* gs = groups + *par * kGroups;
    for (int b = threadIdx.x; b < (1 << width); b += kThreads) h[b] = 0;
    __syncthreads();
    build(h, width, shift, prefix);
    __syncthreads();
    group_sums(h, gs, 1 << width);
    cluster_digit(cluster, h, gs, 1 << width, rem, s_digit, s_left);
    prefix = (prefix << width) | *s_digit;
    rem = *s_left;
    *par ^= 1;
    __syncthreads();  // s_digit and s_left are rewritten by the next digit
  }
  *left = rem;
  return prefix;
}

// In-place inclusive prefix sum of v[0, len) over the block.
__device__ void block_scan(uint32_t* v, int len, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = min(len, static_cast<int>(threadIdx.x) * per);
  const int hi = min(len, lo + per);
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += v[i];
  const uint32_t incl = warp_inclusive(sum);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
    const uint32_t wi = warp_inclusive(w);
    if (lane < kWarps) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  uint32_t run = warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    run += v[i];
    v[i] = run;
  }
  __syncthreads();
}

// Dynamic shared memory of a cluster block: two histograms and their
// group sums (the cluster reads them), the lane's words above the
// threshold (kpad), cached + 2 words a slice node (its cached column
// scores, its bound, then its counts above and equal to the threshold) and
// the places of the block's chunk of words.
__host__ __device__ size_t cluster_smem_bytes(int slice, int kpad, int cluster, int cached) {
  const size_t chunk = (static_cast<size_t>(kpad) + cluster - 1) / cluster;
  return 2 * (kBins + kGroups) * sizeof(uint32_t) + static_cast<size_t>(kpad) * 8 +
         (cached + 2) * static_cast<size_t>(slice) * sizeof(uint32_t) +
         chunk * sizeof(uint32_t);
}

__host__ __device__ int cluster_slice(int n, int cluster) { return (n + cluster - 1) / cluster; }

__device__ __forceinline__ void put(int32_t* choices, float* scores, size_t at, int32_t n,
                                    float s) {
  choices[at] = n;
  scores[at] = s;
}

// One lane over the cluster. `cand` holds 2 * kpad words for each block:
// its words above the threshold, then (as floats) their unclamped scores.
// The block keeps columns kStaged..cached-1 of its nodes (none at cached
// = kStaged); each walk scores the columns past them.
__global__ void __launch_bounds__(kThreads)
closed_form_cluster_kernel(Inputs in, int k, int k_eff, int kpad, int slice, int cached,
                           unsigned long long* cand, int32_t* out_choices,
                           float* out_scores) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t s_digit, s_left, s_above_total, s_equal_total;
  __shared__ uint32_t s_counts[2][kMaxCluster];  // every block's (above, equal)

  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = static_cast<int>(blockIdx.x) / S;
  const int tid = threadIdx.x;
  const int J = in.j;
  const int n0 = rank * slice;
  const int len = max(0, min(in.n - n0, slice));
  const uint32_t ninf_key = order_key(-INFINITY);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem_raw);  // [2][kBins]
  uint32_t* groups = hist + 2 * kBins;                      // [2][kGroups]
  unsigned long long* words = reinterpret_cast<unsigned long long*>(groups + 2 * kGroups);
  float* s_raw = reinterpret_cast<float*>(words + kpad);  // [cached][slice]
  uint32_t* s_bound = reinterpret_cast<uint32_t*>(s_raw + cached * slice);  // then equal
  uint32_t* s_above = s_bound + slice;
  uint32_t* s_place = s_above + slice;
  const auto walk = [&](int i, int len_j, uint32_t fl, auto&& f) {
    const Staged st{s_raw[i], s_raw[slice + i], __uint_as_float(s_bound[i])};
    return walk_staged(in, g, n0 + i, st, s_raw + i, slice, cached, len_j, fl, f);
  };
  const size_t lane_cand = static_cast<size_t>(g) * S * 2 * kpad;
  int32_t* choices = out_choices + static_cast<size_t>(g) * k;
  float* scores = out_scores + static_cast<size_t>(g) * k;
  PROF_START();

  // (1) stage each slice node's head
#pragma unroll 2
  for (int i = tid; i < len; i += kThreads) {
    const Staged st = stage_node(in, g, n0 + i);
    s_raw[i] = st.raw0;
    s_raw[slice + i] = st.raw1;
    s_bound[i] = __float_as_uint(st.jmax);
    for (int j = kStaged; j < cached; ++j) s_raw[j * slice + i] = __int_as_float(0x7fffffff);
  }
  if (tid == 0) {
    s_above_total = 0;
    s_equal_total = 0;
  }
  __syncthreads();
  PROF_LAP(5);
  PROF_CLUSTER_SYNC(cluster);
  PROF_LAP(12);

  // (2) the floor: the k_eff-th largest head of the lane
  int par = 0;
  uint32_t need = 0;
  uint32_t floor = ninf_key;
  if (in.n >= k_eff) {
    floor = cluster_select(
        cluster, hist, groups, &par, static_cast<uint32_t>(k_eff), &s_digit, &s_left, &need,
        [&](uint32_t* h, int width, int shift, uint32_t prefix) {
          const int high = shift + width;
          const uint32_t mask = (1u << width) - 1u;
          for (int base = 0; base < len; base += kThreads) {
            const int i = base + tid;
            const uint32_t key = i < len ? order_key(s_raw[i]) : 0u;
            const bool has = i < len && (high >= 32 || (key >> high) == prefix);
            warp_add(h, has, (key >> shift) & mask, 1u);
          }
        });
  }
  PROF_LAP(6);

  // (3) the threshold: the k_eff-th largest key at or above the floor
  const uint32_t thresh = cluster_select(
      cluster, hist, groups, &par, static_cast<uint32_t>(k_eff), &s_digit, &s_left, &need,
      [&](uint32_t* h, int width, int shift, uint32_t prefix) {
        const int high = shift + width;
        const uint32_t mask = (1u << width) - 1u;
        const auto match = [&](uint32_t key) { return high >= 32 || (key >> high) == prefix; };
        for (int base = 0; base < len; base += kThreads) {
          const int i = base + tid;
          uint32_t run_bin = 0, run_cnt = 0;
          const auto add = [&](uint32_t bin, uint32_t cnt) {
            if (run_cnt != 0 && bin != run_bin) {
              atomicAdd(&h[run_bin], run_cnt);
              run_cnt = 0;
            }
            run_bin = bin;
            run_cnt += cnt;
          };
          if (i < len) {
            const int jcut = walk(i, J, floor, [&](int, uint32_t key, float) {
              if (match(key)) add((key >> shift) & mask, 1u);
            });
            if (floor == ninf_key && jcut < J && match(ninf_key)) {
              add((ninf_key >> shift) & mask, static_cast<uint32_t>(J - jcut));
            }
          }
          warp_add(h, run_cnt != 0, run_bin, run_cnt);
        }
      });
  const uint32_t n_gt = static_cast<uint32_t>(k_eff) - need;
  PROF_LAP(7);

  // (4) each node's keys above the threshold (j < above) and equal to it
  // (the next `equal`); the words above it, and their unclamped scores,
  // into the block's part of the scratch
  unsigned long long* mine = cand + lane_cand + static_cast<size_t>(rank) * 2 * kpad;
  float* mine_raw = reinterpret_cast<float*>(mine + kpad);
  uint32_t my_equal = 0;
  for (int base = 0; base < len; base += kThreads) {
    const int i = base + tid;
    const int n = n0 + i;
    uint32_t above = 0, equal = 0;
    if (i < len) {
      const int jcut = walk(i, J, thresh, [&](int, uint32_t key, float) {
        if (key > thresh) {
          ++above;
        } else {
          ++equal;
        }
      });
      if (thresh == ninf_key) equal += static_cast<uint32_t>(J - jcut);
    }
    const uint32_t incl = warp_inclusive(above);
    uint32_t at = 0;
    if ((tid & 31) == 31 && incl != 0) at = atomicAdd(&s_above_total, incl);
    at = __shfl_sync(kFull, at, 31) + incl - above;
    if (above != 0) {
      const uint32_t idx = static_cast<uint32_t>(n) * J;
      walk(i, static_cast<int>(above), 0u, [&](int j, uint32_t key, float raw) {
        mine[at + j] = compose(key, idx + j);
        mine_raw[at + j] = raw;
      });
    }
    if (i < len) {
      s_above[i] = above;
      s_bound[i] = equal;
    }
    my_equal += equal;
  }
  my_equal = __reduce_add_sync(kFull, my_equal);
  if ((tid & 31) == 0 && my_equal != 0) atomicAdd(&s_equal_total, my_equal);
  __threadfence();
  cluster.sync();  // the counts, and the words in the scratch, are the cluster's
  if (tid < S) {
    s_counts[0][tid] = *cluster.map_shared_rank(&s_above_total, tid);
    s_counts[1][tid] = *cluster.map_shared_rank(&s_equal_total, tid);
  }
  __syncthreads();
  // no block reads another's shared memory after this: arrive now, wait
  // before leaving, so none leaves while another may still read it
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  uint32_t eq_before = 0;
  for (int r = 0; r < rank; ++r) eq_before += s_counts[1][r];
  PROF_LAP(8);

  // (5) this block's ties: the lane's tie ranks [eq_before, ...) below need
  const uint32_t take =
      eq_before >= need ? 0u : min(s_counts[1][rank], need - eq_before);
  const size_t tie0 = static_cast<size_t>(n_gt) + eq_before;
  if (take != 0 && thresh == ninf_key) {
    for (uint32_t t = tid; t < take; t += kThreads) put(choices, scores, tie0 + t, -1, -INFINITY);
  } else if (take != 0) {
    uint32_t* prefix = s_bound;
    block_scan(prefix, len, warp_sums);
    for (uint32_t t = tid; t < take; t += kThreads) {
      int lo = 0, hi = len - 1;  // the first node whose prefix passes t
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (prefix[mid] > t) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      const uint32_t before = lo > 0 ? prefix[lo - 1] : 0u;
      const int n = n0 + lo;
      const int j = static_cast<int>(s_above[lo] + (t - before));
      // a tie's column was walked by the count above, so a cached one is scored
      const float raw = j < cached ? s_raw[j * slice + lo] : raw_score(in, g, n, j, INFINITY);
      put(choices, scores, tie0 + t, n, raw);
    }
  }
  PROF_LAP(9);

  // (6) rank the words above the threshold: all of them into shared
  // memory, each block placing a chunk
  const auto source = [&](uint32_t p, int* r, uint32_t* at) {
    uint32_t off = 0;
    int q = 0;
    while (q < S - 1 && p >= off + s_counts[0][q]) off += s_counts[0][q++];
    *r = q;
    *at = p - off;
  };
  for (uint32_t p = tid; p < n_gt; p += kThreads) {
    int r;
    uint32_t at;
    source(p, &r, &at);
    words[p] = cand[lane_cand + static_cast<size_t>(r) * 2 * kpad + at];
  }
  const uint32_t chunk = (n_gt + S - 1) / S;
  const uint32_t c0 = min(n_gt, rank * chunk);
  const int cnt = static_cast<int>(min(n_gt, c0 + chunk) - c0);
  for (int p = tid; p < cnt; p += kThreads) s_place[p] = 0;
  __syncthreads();
  PROF_LAP(13);
  if (cnt > 0) {
    // `per` threads a word, each over a contiguous span of the words; an
    // odd span starts a warp's parts on different banks (a span that is a
    // multiple of 16 words put them all on one)
    const int per = cnt >= kThreads ? 1 : kThreads / cnt;
    const uint32_t span = ((n_gt + per - 1) / per) | 1u;
    const int part = tid % per;
    for (int p = tid / per; p < cnt; p += kThreads / per) {
      const unsigned long long w = words[c0 + p];
      const uint32_t lo = min(n_gt, part * span);
      const uint32_t hi = min(n_gt, lo + span);
      uint32_t higher = 0;
      for (uint32_t x = lo; x < hi; ++x) higher += words[x] > w ? 1u : 0u;
      if (higher != 0) atomicAdd(&s_place[p], higher);
    }
  }
  __syncthreads();
  PROF_LAP(14);
  for (int p = tid; p < cnt; p += kThreads) {
    const uint32_t idx = 0xffffffffu - static_cast<uint32_t>(words[c0 + p]);
    int r;
    uint32_t at;
    source(c0 + p, &r, &at);
    const float* raw = reinterpret_cast<const float*>(
        cand + lane_cand + static_cast<size_t>(r) * 2 * kpad + kpad);
    put(choices, scores, s_place[p], static_cast<int>(idx / static_cast<uint32_t>(J)),
        raw[at]);
  }
  for (int i = k_eff + rank * kThreads + tid; i < k; i += S * kThreads) {
    put(choices, scores, i, -1, -INFINITY);
  }
  PROF_BARRIER();
  PROF_LAP(10);
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  PROF_LAP(11);
  PROF_END();
}

// Per device: the dynamic shared memory a cluster block may take, the SM
// count, and the cluster kernel's attributes set once (non-portable
// cluster sizes allowed, the opt-in shared memory granted). A thread-safe
// static, set by the first plan, never inside a graph capture.
struct ClusterGrant {
  int error;
  size_t room;
  int sms;
};

const ClusterGrant& cluster_grant() {
  static const ClusterGrant granted = [] {
    ClusterGrant out{0, 0, 0};
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, dev);
    out.room = static_cast<size_t>(optin);
    const void* kernel = reinterpret_cast<const void*>(closed_form_cluster_kernel);
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) out.room -= attr.sharedSizeBytes;
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(out.room));
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    out.error = static_cast<int>(e);
    return out;
  }();
  return granted;
}

// Clusters of S blocks that can be resident at once with `smem` bytes of
// dynamic shared memory a block (cudaOccupancyMaxActiveClusters).
cudaError_t resident_clusters(int s, size_t smem, int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, s, kThreads, smem, nullptr, &attr);
  *clusters = 0;
  return cudaOccupancyMaxActiveClusters(clusters, closed_form_cluster_kernel, &cfg);
}

// Columns a block of G lanes of S blocks keeps a node: the most up to
// kMaxCached at which all G clusters are still resident at once (a larger
// share can cost a wave: caching six at G 32 on 4 blocks a lane took
// 0.105 ms against 0.058), else kStaged; 0 where not even that fits.
cudaError_t kept_columns(const ClusterGrant& granted, int g, int n, int kpad, int s,
                         int* cached) {
  *cached = 0;
  const int slice = cluster_slice(n, s);
  for (int c = kMaxCached; c >= kStaged; --c) {
    const size_t smem = cluster_smem_bytes(slice, kpad, s, c);
    if (smem > granted.room) continue;
    int resident = 0;
    const cudaError_t e = resident_clusters(s, smem, &resident);
    if (e != cudaSuccess) return e;
    if (resident >= g || c == kStaged) {
      *cached = c;
      break;
    }
  }
  return cudaSuccess;
}

}  // namespace

// The plan of a launch of G lanes over N nodes with kpad top-k slots:
// the blocks a lane runs on and the columns a cluster block keeps a node.
// *by_shape: `want` where it is 1..16 (a form asked for), else the size
// by shape, which never rises with G (measured on an H100, PERF.md: a
// lane on 16 blocks is fastest while each block has an SM of its own, on
// 8 while all G clusters of 8 are resident at once, and past that 4
// blocks a lane beat 2 and 8 at every G measured but 64): 16 while
// G x 16 <= SMs, 8 while cudaOccupancyMaxActiveClusters holds G clusters
// of 8, else 4; 1 (the one-block form) where a block's share does not
// fit in shared memory. *blocks: that S, halved while
// cudaOccupancyMaxActiveClusters says no cluster of it can be resident.
// *cached: kept_columns at *blocks (0 for the one-block form). A size
// asked for whose share does not fit is refused (cudaErrorInvalidValue).
extern "C" int nomad_closed_form_cluster(int g, int n, int kpad, int want, int* by_shape,
                                         int* blocks, int* cached) {
  const ClusterGrant& granted = cluster_grant();
  *by_shape = 1;
  *blocks = 1;
  *cached = 0;
  if (granted.error != 0) return granted.error;
  if (want == 1) return 0;
  if (want < 0 || want > kMaxCluster || (want & (want - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int s = want;
  if (s == 0) {
    s = 16;
    if (static_cast<long long>(g) * 16 > granted.sms) {
      int resident = 0;
      const size_t smem8 = cluster_smem_bytes(cluster_slice(n, 8), kpad, 8, kStaged);
      if (smem8 <= granted.room) {
        const cudaError_t e = resident_clusters(8, smem8, &resident);
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      s = resident >= g ? 8 : 4;
    }
  }
  const auto smem = [&] { return cluster_smem_bytes(cluster_slice(n, s), kpad, s, kStaged); };
  if (smem() > granted.room) return want != 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
  *by_shape = s;
  for (; s > 1 && smem() <= granted.room; s >>= 1) {
    int resident = 0;
    const cudaError_t e = resident_clusters(s, smem(), &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (resident >= 1) {
      *blocks = s;
      return static_cast<int>(kept_columns(granted, g, n, kpad, s, cached));
    }
  }
  return 0;
}

// C entry point, bound with ctypes (nomad_tpu_torch/device/score.py).
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// so a refused launch is reported to the caller. `cluster` and `cached`
// are nomad_closed_form_cluster's *blocks and *cached: a cluster of 1 runs
// the one-block form, whose scratch `cand` holds kpad words a lane; 2..16
// the cluster form, 2 * kpad words a block.
extern "C" int nomad_place_closed_form(
    const float* capacity, const float* used0, const float* asks,
    const uint8_t* eligible, const int32_t* job_counts,
    const float* desired_totals, const uint8_t* penalty, const float* affinity,
    const uint8_t* has_aff, const uint8_t* distinct, const float* slot_caps,
    const float* jitter, int algorithm_spread, int g, int n, int j, int k,
    int k_eff, int kpad, int cluster, int cached, unsigned long long* cand,
    int32_t* out_choices,
    float* out_scores, void* stream) {
  Inputs in{capacity, used0,     asks,     eligible, job_counts,
            desired_totals, penalty, affinity, has_aff,  distinct,
            slot_caps, jitter, algorithm_spread, n, j};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 1) {
    const ClusterGrant& granted = cluster_grant();
    if (granted.error != 0) return granted.error;
    const int slice = cluster_slice(n, cluster);
    if (cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 || cached < kStaged ||
        cached > kMaxCached || cluster_smem_bytes(slice, kpad, cluster, cached) > granted.room) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = cluster_smem_bytes(slice, kpad, cluster, cached);
    return static_cast<int>(launch_cluster(closed_form_cluster_kernel, g, cluster, kThreads,
                                           smem, st, in, k, k_eff, kpad, slice, cached, cand,
                                           out_choices, out_scores));
  }
  const size_t smem =
      kpad <= kSmemSortMax ? static_cast<size_t>(kpad) * sizeof(unsigned long long) : 0;
  closed_form_kernel<<<g, kThreads, smem, st>>>(in, k, k_eff, kpad, cand, out_choices,
                                                out_scores);
  return static_cast<int>(cudaGetLastError());
}

// -- the cross-shard top-k merge ----------------------------------------------
//
// Under a node-axis mesh each of S shards runs the closed form above on
// its contiguous slice of seg nodes and returns its own top k' (k' =
// min(k, seg * J)): node rows local to the slice and unclamped scores, in
// the order (clamped score desc, index asc). closed_form_topk_merge makes
// the global top k from the S * k' candidates of a group, concatenated
// shard-major, in lax.top_k's order (clamped score desc, then position
// asc, which is the lowest global index: slices are contiguous and
// node-major), exactly the reference's _topk_nodes merge.
//
// The clamped score of a candidate is not in a shard's output, but it is
// the prefix minimum of the order keys of the unclamped scores along the
// shard's list. Proof: the list is sorted by clamped key K, so K_i <=
// K_{i-1}; the column j - 1 of a pick's node is ranked before it (key at
// least as large, lower index) and K_i = min(raw_i, K of that entry). If
// raw_i <= K_{i-1}, that entry's K >= K_{i-1} >= raw_i gives K_i = raw_i
// (also when the pick is the node's column 0). Else K_i < raw_i, so the
// pick is not column 0 and K_i is that entry's K >= K_{i-1}: K_i =
// K_{i-1}. Either way K_i = min(raw_i, K_{i-1}). Entries at -inf (row -1)
// end every list and keep key(-inf).
//
// One block a group: a block-wide min scan writes each shard's keys to
// `keys`, then each candidate's place is its index in its own list plus,
// by binary search, the entries of every other list ranked before it
// (key at least its own in an earlier shard, strictly greater in a later
// one): the lists are sorted and the (key, position) words unique, so the
// places are a permutation. A place below k writes the candidate's global
// row (slice offset added) and its score's bits into the fused [G, 2k]
// output; places S * k' .. k - 1, where the lists hold fewer than k, are
// row -1 / -inf.

namespace {

constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMaxShards = 64;

struct MergeIn {
  const int32_t* rows[kMaxShards];  // shard s: [G, kl] local node rows
  const float* scores[kMaxShards];  // shard s: [G, kl] unclamped scores
};

// Entries of a non-increasing list of n keys that rank before a
// candidate with key `key`: those >= key when `ties_before`, else > key.
__device__ __forceinline__ int ranked_before(const uint32_t* list, int n, uint32_t key,
                                             bool ties_before) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = ties_before ? list[mid] >= key : list[mid] > key;
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads)
closed_form_topk_merge_kernel(MergeIn in, int S, int kl, int seg, int k, uint32_t* keys,
                              int32_t* out) {
  __shared__ uint32_t warp_min[kMergeWarps];
  __shared__ uint32_t carry;
  const int g = static_cast<int>(blockIdx.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t* gkeys = keys + static_cast<size_t>(g) * S * kl;

  // clamped keys: a min scan along each shard's list, a chunk of
  // kMergeThreads entries at a time, carried across chunks
  for (int s = 0; s < S; ++s) {
    const float* sc = in.scores[s] + static_cast<size_t>(g) * kl;
    if (tid == 0) carry = 0xffffffffu;
    __syncthreads();
    for (int base = 0; base < kl; base += kMergeThreads) {
      const int i = base + tid;
      uint32_t v = i < kl ? order_key(sc[i]) : 0xffffffffu;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v = min(v, u);
      }
      if (lane == 31) warp_min[warp] = v;
      __syncthreads();
      uint32_t before = carry;
      for (int w = 0; w < warp; ++w) before = min(before, warp_min[w]);
      v = min(v, before);
      if (i < kl) gkeys[static_cast<size_t>(s) * kl + i] = v;
      __syncthreads();  // every thread has read carry and warp_min
      if (tid == kMergeThreads - 1) carry = v;
      __syncthreads();
    }
  }

  int32_t* rows_out = out + static_cast<size_t>(g) * 2 * k;
  int32_t* bits_out = rows_out + k;
  const int total = S * kl;
  for (int p = tid; p < total; p += kMergeThreads) {
    const int s = p / kl;
    const int i = p - s * kl;
    const uint32_t key = gkeys[p];
    int place = i;
    for (int t = 0; t < S && place < k; ++t) {
      if (t != s) place += ranked_before(gkeys + static_cast<size_t>(t) * kl, kl, key, t < s);
    }
    if (place < k) {
      const size_t at = static_cast<size_t>(g) * kl + i;
      const int32_t row = in.rows[s][at];
      rows_out[place] = row < 0 ? -1 : row + s * seg;
      bits_out[place] = __float_as_int(in.scores[s][at]);
    }
  }
  for (int p = total + tid; p < k; p += kMergeThreads) {
    rows_out[p] = -1;
    bits_out[p] = __float_as_int(-INFINITY);
  }
}

}  // namespace

// C entry point of the merge, bound with ctypes (device/score.py):
// `rows` and `scores` are host arrays of S device pointers, shard s's
// [G, kl] candidates; `keys` a u32 scratch of G * S * kl words; `out` the
// fused i32 [G, 2k] output (rows, then the scores' bits). Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int nomad_closed_form_topk_merge(const int32_t* const* rows,
                                            const float* const* scores, int s, int g, int kl,
                                            int seg, int k, uint32_t* keys, int32_t* out,
                                            void* stream) {
  if (s < 1 || s > kMaxShards || g < 0 || kl < 1 || k < 1 || seg < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 0) return 0;
  MergeIn in{};
  for (int i = 0; i < s; ++i) {
    in.rows[i] = rows[i];
    in.scores[i] = scores[i];
  }
  closed_form_topk_merge_kernel<<<g, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, s, kl, seg, k, keys, out);
  return static_cast<int>(cudaGetLastError());
}
