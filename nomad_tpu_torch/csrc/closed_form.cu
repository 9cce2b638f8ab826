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
// far fewer near the top k.
//
// Design, one thread block per lane, and no plane in device memory:
//  - a thread walks one node's column at a time, recomputing the clamped
//    scores as order-preserving u32 keys; the -inf tail past the node's
//    feasible-column bound is counted, never walked;
//  - a floor first: the k-th largest column head (j = 0), found by radix
//    select over the N heads. At least k keys lie at or above it, so no
//    key below it is a pick, and since the clamp makes every column
//    non-increasing, each later walk stops at the first key under the
//    floor -- most columns after one candidate. Without it, a walk costs
//    the longest column of each warp (node sizes vary 4x), four times;
//  - radix select of the k-th largest key over 11/11/10-bit digits, one
//    floored walk per digit, histograms in shared memory;
//  - one more walk compacts the picks: keys above the threshold take
//    slots in any order, keys equal to it are ranked in index order
//    (n*J + j) by a block-wide scan over the nodes of each round, so the
//    lowest indices win ties, as in lax.top_k;
//  - a bitonic sort of the k (key, ~index) pairs -- in shared memory up
//    to 4,096 slots, in the lane's scratch beyond -- and the raw score
//    recomputed for each pick from its (n, j).
//
// Numerics: the per-candidate arithmetic is candidate.cuh's (IEEE
// division, expf, no FMA contraction), shared with the coupled kernels.

#include "candidate.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;          // 11-bit radix digits
constexpr int kSmemSortMax = 4096;   // top-k slots sorted in shared memory

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

  // (a) a floor under the picks: the k_eff-th largest column head. The
  // k_eff columns whose heads reach it hold k_eff keys at or above it,
  // so no key below it is a pick, and every later walk stops there.
  uint32_t need = 0;
  uint32_t floor = ninf_key;
  if (in.n >= k_eff) {
    floor = select_key(in, g, hist, 1, ninf_key, static_cast<uint32_t>(k_eff),
                       &s_digit, &s_left, &need);
  }
  // (b) the k_eff-th largest key, and how many keys equal to it to take
  const uint32_t thresh = select_key(in, g, hist, J, floor,
                                     static_cast<uint32_t>(k_eff), &s_digit,
                                     &s_left, &need);
  const uint32_t n_gt = static_cast<uint32_t>(k_eff) - need;

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
}

}  // namespace

// C entry point, bound with ctypes (nomad_tpu_torch/device/score.py).
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// so a refused launch is reported to the caller.
extern "C" int nomad_place_closed_form(
    const float* capacity, const float* used0, const float* asks,
    const uint8_t* eligible, const int32_t* job_counts,
    const float* desired_totals, const uint8_t* penalty, const float* affinity,
    const uint8_t* has_aff, const uint8_t* distinct, const float* slot_caps,
    const float* jitter, int algorithm_spread, int g, int n, int j, int k,
    int k_eff, int kpad, unsigned long long* cand, int32_t* out_choices,
    float* out_scores, void* stream) {
  Inputs in{capacity, used0,     asks,     eligible, job_counts,
            desired_totals, penalty, affinity, has_aff,  distinct,
            slot_caps, jitter, algorithm_spread, n, j};
  const size_t smem =
      kpad <= kSmemSortMax ? static_cast<size_t>(kpad) * sizeof(unsigned long long) : 0;
  closed_form_kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, k, k_eff, kpad, cand, out_choices, out_scores);
  return static_cast<int>(cudaGetLastError());
}
