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
// Design:
//  - V <= 32 (the common case: a handful of allocations per node): one
//    warp holds 32 / Vp rows, Vp the next power of two of V, one victim a
//    lane. A bitonic network of register shuffles sorts each row's
//    segment, shuffle scans give the prefixes, and a ballot finds the
//    first fitting prefix. Nothing touches shared memory.
//  - 32 < V: one block per row sorts the row's Vp composite keys
//    (bitonic), each thread scans a contiguous chunk of the sorted row on
//    top of a block scan of the chunk totals, and the first fitting slot
//    is a shared 64-bit atomicMin on (slot << 32 | net priority). Where
//    the Vp sort words live sets the form: V <= 4,096 in the default
//    dynamic shared memory (32 KB); V <= 16,384 in Hopper's opt-in
//    dynamic shared memory (128 KB, under the 227 KB a block may take);
//    above that in a global scratch of Vp words a block, the sort's
//    stages going through L1 and L2, with as many blocks as are resident
//    looping over the rows so that the scratch is resident blocks x Vp
//    words, not N x Vp. Every form addresses a row's words with an int
//    Vp and keeps a victim's index in a word's low 32 bits: V <= 2^30.
//  - choose, V <= 32: a warp holds 32 / Vp rows, one victim a lane, so
//    its loads are one contiguous run of 16-byte victim records and mask
//    bytes (at V 8, four rows a warp), loaded whatever the mask says and
//    masked by a select; a butterfly of shuffles inside each row's Vp
//    lanes sums the row, and its first lane scores it. V > 32: one warp
//    a row, each lane adding every 32nd victim with 16-byte loads, then a
//    butterfly. The argmax is a block reduction of (order_key(score) <<
//    32 | ~row) words and a 64-bit atomicMax across blocks (the largest
//    score, then the lowest row, whatever the atomics' order); the last
//    block to finish decodes it.
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

#include "candidate.cuh"

namespace {

constexpr int kMaxVictimWidth = 1 << 30;  // Vp in an int, index in 32 bits
constexpr int kSmemWords = 4096;          // block form, default shared memory
constexpr int kOptinWords = 16384;        // block form, opt-in shared memory
constexpr int kWarpThreads = 256;   // warp form: 8 warps a block
constexpr int kChooseThreads = 256;
constexpr int kMaxBlockThreads = 256;
constexpr int kGlobalThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadWord = ~0ULL;

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

// Sort word of victim i of a row: its key's order, then its index.
__device__ unsigned long long victim_word(const Pass& p, int row, int i) {
  const size_t rv = static_cast<size_t>(row) * p.v + i;
  float key = 1e9f;
  if (p.victim_mask[rv]) {
    const float* res = p.victim_res + 4 * rv;
    float sum = 0.0f;
    for (int d = 0; d < 4; ++d) {
      const float rel =
          __fdiv_rn(__fsub_rn(res[d], p.ask[d]), fmaxf(p.ask[d], 1.0f));
      sum = __fadd_rn(sum, __fmul_rn(rel, rel));
    }
    const float dist = __fsqrt_rn(sum);
    key = __fadd_rn(__fmul_rn(static_cast<float>(p.victim_prio[rv]), 1e4f),
                    fminf(dist, 9e3f));
  }
  return (static_cast<unsigned long long>(order_key(key)) << 32) |
         static_cast<unsigned>(i);
}

// Does the ask fit on `row` once `freed` is released?
__device__ bool fits_after(const Pass& p, int row, const float* freed) {
  bool ok = true;
  for (int d = 0; d < 4; ++d) {
    const size_t rd = 4 * static_cast<size_t>(row) + d;
    const float left = __fadd_rn(__fsub_rn(p.used[rd], freed[d]), p.ask[d]);
    ok = ok && left <= p.capacity[rd];
  }
  return ok;
}

__device__ void write_row(const Pass& p, int row, bool any, int first,
                          int net) {
  p.feasible[row] = any ? 1 : 0;
  p.k[row] = any ? first + 1 : 0;
  p.net[row] = any ? static_cast<float>(net) : 0.0f;
}

// V <= 32: each warp holds 32 / width rows, `width` a power of two >= V.
__global__ void __launch_bounds__(kWarpThreads)
find_warp_kernel(Pass p, int width) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int seg = lane / width;
  const int sub = lane & (width - 1);
  const long long wide_row = warp * (32 / width) + seg;
  const int row = wide_row < p.n ? static_cast<int>(wide_row) : p.n;
  const bool in_row = row < p.n;
  const bool slot = in_row && sub < p.v;

  unsigned long long w = slot ? victim_word(p, row, sub) : kPadWord;
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, w, stride);
      const bool ascending = (sub & size) == 0;
      const bool lower = (sub & stride) == 0;
      w = (lower == ascending) ? (o < w ? o : w) : (o > w ? o : w);
    }
  }
  // padding words sort last, so slot `sub` holds the sub-th real victim
  const int idx = static_cast<int>(w & 0xffffffffu);
  const size_t rv = static_cast<size_t>(row) * p.v + idx;
  const bool real = slot && p.victim_mask[rv];
  float freed[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int prio = 0;
  if (real) {
    for (int d = 0; d < 4; ++d) freed[d] = p.victim_res[4 * rv + d];
    prio = p.victim_prio[rv];
  }
  if (slot) p.order[static_cast<size_t>(row) * p.v + sub] = idx;
  for (int off = 1; off < width; off <<= 1) {
    float up[4];
    for (int d = 0; d < 4; ++d) up[d] = __shfl_up_sync(kFull, freed[d], off, width);
    const int up_prio = __shfl_up_sync(kFull, prio, off, width);
    if (sub >= off) {
      for (int d = 0; d < 4; ++d) freed[d] = __fadd_rn(freed[d], up[d]);
      prio += up_prio;
    }
  }
  const bool fit = real && fits_after(p, row, freed);
  const unsigned bits = __ballot_sync(kFull, fit);
  const unsigned seg_bits =
      (bits >> (seg * width)) & (width == 32 ? kFull : ((1u << width) - 1u));
  const int first = __ffs(seg_bits) - 1;
  const int net = __shfl_sync(kFull, prio, seg * width + (first < 0 ? 0 : first));
  if (in_row && sub == 0) {
    write_row(p, row, seg_bits != 0 && p.eligible[row] != 0, first, net);
  }
}

// 32 < V: one block of `blockDim.x` (<= kThreads) threads sorts and
// scans row `row`, its `vp` sort words at `words` (shared or global).
template <int kThreads>
__device__ void find_row(const Pass& p, int vp, unsigned long long* words,
                         int row) {
  __shared__ float warp_freed[4][kThreads / 32];
  __shared__ int warp_prio[kThreads / 32];
  __shared__ unsigned long long hit;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < vp; i += threads) {
    words[i] = i < p.v ? victim_word(p, row, i) : kPadWord;
  }
  if (tid == 0) hit = kPadWord;
  __syncthreads();
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
  float freed[4];
  int prio;
  {
    float ex[4];
    for (int d = 0; d < 4; ++d) ex[d] = __shfl_up_sync(kFull, inc[d], 1);
    int ex_prio = __shfl_up_sync(kFull, inc_prio, 1);
    if (lane == 0) {
      for (int d = 0; d < 4; ++d) ex[d] = 0.0f;
      ex_prio = 0;
    }
    for (int d = 0; d < 4; ++d) {
      freed[d] = warp > 0 ? __fadd_rn(warp_freed[d][warp - 1], ex[d]) : ex[d];
    }
    prio = (warp > 0 ? warp_prio[warp - 1] : 0) + ex_prio;
  }
  bool hit_here = false;
  for (int e = 0; e < per; ++e) {
    const int s = base + e;
    if (s >= p.v) break;
    const int idx = static_cast<int>(words[s] & 0xffffffffu);
    p.order[row_v + s] = idx;
    const size_t rv = row_v + idx;
    if (hit_here || !p.victim_mask[rv]) continue;
    for (int d = 0; d < 4; ++d) {
      freed[d] = __fadd_rn(freed[d], p.victim_res[4 * rv + d]);
    }
    prio += p.victim_prio[rv];
    if (fits_after(p, row, freed)) {
      atomicMin(&hit, (static_cast<unsigned long long>(s) << 32) |
                          static_cast<unsigned>(prio));
      hit_here = true;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const bool found = hit != kPadWord;
    write_row(p, row, found && p.eligible[row] != 0,
              found ? static_cast<int>(hit >> 32) : -1,
              static_cast<int>(static_cast<unsigned>(hit & 0xffffffffu)));
  }
  __syncthreads();  // `hit` and the words are reused by the block's next row
}

// 32 < V <= 16,384: one block per row, the sort words in dynamic shared
// memory (opted in above the default 48 KB for V > 4,096).
__global__ void __launch_bounds__(kMaxBlockThreads)
find_block_kernel(Pass p, int vp) {
  extern __shared__ unsigned long long smem_words[];
  find_row<kMaxBlockThreads>(p, vp, smem_words, blockIdx.x);
}

// V > 16,384: the resident blocks loop over the rows, each sorting in its
// own Vp words of the global scratch.
__global__ void __launch_bounds__(kGlobalThreads)
find_global_kernel(Pass p, int vp, unsigned long long* scratch) {
  unsigned long long* words = scratch + static_cast<size_t>(blockIdx.x) * vp;
  for (int row = blockIdx.x; row < p.n; row += gridDim.x) {
    find_row<kGlobalThreads>(p, vp, words, row);
  }
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

// The block form's opt-in to the larger dynamic shared memory, once a
// device (the attribute stays set for the process).
cudaError_t opt_in_block_form() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(
      find_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOptinWords * static_cast<int>(sizeof(unsigned long long)));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
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

int padded_width(int v) {
  int vp = 1;
  while (vp < v) vp <<= 1;
  return vp;
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
// lane l victim l % vp of row l / vp; the warps loop over the rows.
__global__ void __launch_bounds__(kChooseThreads)
choose_kernel(Choose c, int vp) {
  __shared__ unsigned long long warp_best[kChooseThreads / 32];
  const int lane = threadIdx.x & 31;
  const int i = lane % vp;
  const long long rows_per_warp = 32 / vp;
  const long long warps = static_cast<long long>(gridDim.x) * (kChooseThreads / 32);
  unsigned long long word = 0;
  for (long long first = (static_cast<long long>(blockIdx.x) * (kChooseThreads / 32) +
                          (threadIdx.x >> 5)) * rows_per_warp;
       first < c.n; first += warps * rows_per_warp) {
    const long long wide_row = first + lane / vp;
    const bool in = wide_row < c.n && i < c.v;
    ChooseRow row_in{};
    if (i == 0 && wide_row < c.n) row_in = choose_row(c, static_cast<int>(wide_row));
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in) {
      const size_t rv = static_cast<size_t>(wide_row) * c.v + i;
      const float4 x = *reinterpret_cast<const float4*>(c.victim_res + 4 * rv);
      const bool masked = c.victim_mask[rv] != 0;
      r = masked ? x : r;
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
  choose_argmax(c, word, warp_best);
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

}  // namespace

// C entry points, bound with ctypes (nomad_tpu_torch/device/preempt.py).
// Each launches on `stream`, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported to the caller.

// 64-bit words of the scratch `nomad_find_preemption` takes for N rows of
// V victims (0 unless the global form runs); a negative cudaError on
// failure.
extern "C" long long nomad_find_preemption_scratch_words(int n, int v) {
  if (n < 1 || v < 1 || v > kMaxVictimWidth) {
    return -static_cast<long long>(cudaErrorInvalidValue);
  }
  const int vp = padded_width(v);
  if (vp <= kOptinWords) return 0;
  int grid = 0;
  const cudaError_t e = global_grid(n, &grid);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(grid) * vp;
}

// `scratch` holds nomad_find_preemption_scratch_words(n, v) words (none
// needed, and it may be null, for V <= 16,384).
extern "C" int nomad_find_preemption(
    const float* capacity, const float* used, const float* ask,
    const uint8_t* eligible, const float* victim_res,
    const int32_t* victim_prio, const uint8_t* victim_mask, int n, int v,
    uint8_t* feasible, int32_t* k, float* net, int32_t* order,
    unsigned long long* scratch, void* stream) {
  if (n < 1 || v < 1 || v > kMaxVictimWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pass p{capacity, used,  ask,  eligible, victim_res, victim_prio,
               victim_mask, n, v,  feasible, k,          net,
               order};
  const int vp = padded_width(v);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vp <= 32) {
    const long long warps = (static_cast<long long>(n) + 32 / vp - 1) / (32 / vp);
    const long long blocks = (warps * 32 + kWarpThreads - 1) / kWarpThreads;
    find_warp_kernel<<<static_cast<unsigned>(blocks), kWarpThreads, 0, s>>>(p, vp);
  } else if (vp <= kOptinWords) {
    const int threads = vp < kMaxBlockThreads ? vp : kMaxBlockThreads;
    const int bytes = vp * static_cast<int>(sizeof(unsigned long long));
    if (vp > kSmemWords) {
      const cudaError_t e = opt_in_block_form();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    find_block_kernel<<<n, threads, bytes, s>>>(p, vp);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int grid = 0;
    const cudaError_t e = global_grid(n, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    find_global_kernel<<<grid, kGlobalThreads, 0, s>>>(p, vp, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nomad_choose_preemption_node(
    const float* capacity, const float* used, const float* ask,
    const float* victim_res, const uint8_t* victim_mask,
    const uint8_t* feasible, const float* net, int n, int v,
    unsigned long long* scratch, int32_t* best, float* score, void* stream) {
  if (n < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Choose c{capacity, used, ask,     victim_res, victim_mask, feasible,
                 net,      n,    v,       scratch,    best,        score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(victim_res) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v <= 32) {
    const int vp = padded_width(v);
    const long long warps = (static_cast<long long>(n) + 32 / vp - 1) / (32 / vp);
    const long long blocks = (warps + kChooseThreads / 32 - 1) / (kChooseThreads / 32);
    int grid = 0;
    const cudaError_t e = choose_grid(blocks, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    choose_kernel<<<static_cast<unsigned>(grid), kChooseThreads, 0, s>>>(c, vp);
  } else {
    const int rows = kChooseThreads / 32;
    const long long blocks = (static_cast<long long>(n) + rows - 1) / rows;
    choose_wide_kernel<<<static_cast<unsigned>(blocks), kChooseThreads, 0, s>>>(c);
  }
  return static_cast<int>(cudaGetLastError());
}
