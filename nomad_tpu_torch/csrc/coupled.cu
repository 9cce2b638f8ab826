// Coupled greedy placement on Hopper (sm_90a): spread and
// distinct_property groups.
//
// Replaces three programs of nomad_tpu/device/score.py:
//  - place_value_scan_kernel: exact stepwise greedy, one placement per
//    step, the per-(block, value) boost/allowance tables re-derived from
//    the count state before every step;
//  - place_spread_chunked_kernel: the tables frozen for CHUNK placements
//    at a time, each chunk the top CHUNK of the running-min-clamped
//    [N, J] plane from every node's next column;
//  - place_spread_opv_kernel: one-per-value chunks for even-mode spread
//    -- a first pick with the frozen tables, the tables re-derived, then
//    at most one more pick per value segment of the enforced block.
// Each computes what its reference computes, output for output: choices
// i32[G, S] and the unclamped score of each pick f32[G, S], -1 / -inf in
// slots that took nothing.
//
// What bounds them on the H100: not bytes -- a lane's inputs are ~0.8 MB
// at 16,384 nodes -- but sequential depth. Each step depends on the
// previous one's pick through the count state, so a lane is a chain of
// up to 256 steps (value scan) or 20 steps of 16 rounds (chunked), each
// a pass over all nodes, a block-wide reduction and a few barriers, on
// one SM. Within a step the pass dominates: each thread reads its 16
// nodes' value ids from L2 one after another (~10 us a pass at 16,384
// nodes, from the measured step times in PERF.md), then a round costs
// ~2 us. Staging the value ids on chip and splitting a lane over several
// SMs (clusters or cooperative groups) are later work.
//
// Design: one 1,024-thread block per lane, the whole scan inside the
// launch, no [N, J] plane anywhere.
//  - Thread t owns nodes t, t + 1024, ... . Per node the lane keeps its
//    head state in 13 bytes: the numerator at its next column jn
//    (candidate.cuh), the chunked scan's clamped value, jn, the column
//    cap (jn fits while jn < cap) and the denominator (a small integer).
//    Only a picked node's column moves, so only its head is recomputed.
//  - That state, the count state c[B, V], the boost and allowance
//    tables, the per-block min/max of positive counts and the opv
//    segment maxima form one region per lane, in shared memory when it
//    fits (213 KB at the path's 16,384 nodes, B 1, V 32), else in the
//    lane's global scratch, so no input the reference takes is refused.
//    A scoring pass then reads shared memory and the value ids (through
//    the read-only path) only. Min/max are per-warp shuffle reductions.
//  - A score is the head numerator plus the summed boost over the head
//    denominator plus one (when the boost is nonzero), -inf where the
//    head does not fit or a distinct_property cap is full.
//  - Argmax is a block-wide max over (order key << 32 | ~index) words,
//    so ties go to the lowest index, as jnp.argmax and lax.top_k order.
//  - The value scan is the chunked scan with chunks of one: with one
//    pick per chunk the clamp is the raw score and the top-1 is the
//    first-index argmax.
//  - Chunked: within a step each node's clamped sequence from jn on is
//    non-increasing, so the top CHUNK of the plane is CHUNK rounds of
//    block argmax over per-node clamped heads; the winner's node takes
//    its next column and folds it into its running minimum. The pick's
//    score is its unclamped value.
//  - One-per-value: segment maxima by 64-bit integer atomicMax on
//    (order key, ~row) words -- integer, so the result does not depend on
//    the order of the atomics -- then k_seg - 1 rounds of block argmax
//    over the V + 1 segments, behind the rotation guard.
//  - A step that takes nothing leaves the state unchanged, so every later
//    step would take nothing too: the scan stops there.
//
// Numerics: candidate.cuh's (IEEE division, expf, -fmad=false). No float
// atomics; every float sum runs in the reference's order.

#include "candidate.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetSpread = 0;
constexpr int kEvenSpread = 1;
constexpr int kDistinctCap = 2;

struct Blocks {
  const int32_t* value_ids;  // [G, B, N], -1 = node has no value
  const float* counts0;      // [G, B, V]
  const float* desired;      // [G, B, V]
  const float* caps;         // [G, B, V]
  const float* weights;      // [G, B]
  const int32_t* kinds;      // [G, B]
  int b;
  int v;
};

// The per-lane region: tables (count state, boost and allowance, the
// per-block min/max of positive counts, the opv segment state) and the
// per-node head state.
struct Tables {
  unsigned long long* seg_best;  // [V + 1] (order key << 32 | ~row)
  float* c;                      // [B * V]
  float* tbl;                    // [B * V]
  float* minc;                   // [B]
  float* maxc;                   // [B]
  int32_t* allow;                // [B * V]
  int32_t* seg_ok;               // [V + 1]
  int32_t* present;              // [V]
  float* head_num;               // [N] numerator at column jn
  float* sel;                    // [N] chunked: clamped value of column jn
  uint16_t* jn;                  // [N] next column
  uint16_t* jcap;                // [N] columns that fit: jn fits iff jn < jcap
  uint8_t* head_den;             // [N] denominator at column jn (1..4)
};

__host__ __device__ size_t region_bytes(int n, int b, int v) {
  const size_t bv = static_cast<size_t>(b) * v;
  const size_t bytes = 8 * static_cast<size_t>(v + 1) +
                       4 * (2 * bv + 2 * b + 2 * static_cast<size_t>(n)) +
                       4 * (bv + static_cast<size_t>(v + 1) + v) +
                       2 * 2 * static_cast<size_t>(n) + static_cast<size_t>(n);
  return (bytes + 15) & ~static_cast<size_t>(15);
}

__device__ Tables carve(unsigned char* base, int n, int b, int v) {
  Tables t;
  const size_t bv = static_cast<size_t>(b) * v;
  t.seg_best = reinterpret_cast<unsigned long long*>(base);
  float* f = reinterpret_cast<float*>(base + 8 * static_cast<size_t>(v + 1));
  t.c = f;
  t.tbl = f + bv;
  t.minc = f + 2 * bv;
  t.maxc = f + 2 * bv + b;
  t.head_num = f + 2 * bv + 2 * b;
  t.sel = t.head_num + n;
  int32_t* i = reinterpret_cast<int32_t*>(t.sel + n);
  t.allow = i;
  t.seg_ok = i + bv;
  t.present = i + bv + v + 1;
  t.jn = reinterpret_cast<uint16_t*>(t.present + v);
  t.jcap = t.jn + n;
  t.head_den = reinterpret_cast<uint8_t*>(t.jcap + n);
  return t;
}

struct Lane {
  Inputs in;
  Blocks bl;
  Tables t;
  int g;
  const int32_t* vids;   // this lane's [B, N]
  const int32_t* kinds;  // this lane's [B]
  bool any_spread;
};

__device__ __forceinline__ unsigned long long pack(float value, uint32_t idx) {
  // larger word = larger value, then smaller index
  return (static_cast<unsigned long long>(order_key(value)) << 32) |
         (0xffffffffu - idx);
}

__device__ __forceinline__ float packed_value(unsigned long long w) {
  return key_value(static_cast<uint32_t>(w >> 32));
}

__device__ __forceinline__ uint32_t packed_index(unsigned long long w) {
  return 0xffffffffu - static_cast<uint32_t>(w);
}

// Block-wide max of one word per thread; every thread gets the result.
__device__ unsigned long long block_max(unsigned long long x,
                                        unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, o);
      x = y > x ? y : x;
    }
    if (lane == 0) red[kWarps] = x;
  }
  __syncthreads();
  return red[kWarps];
}

// Boost and allowance tables from the count state (reference
// _block_tables). Target: (desired - (c+1)) / max(desired, 1e-9) * w,
// -1 where desired <= 0. Even: from the min/max of positive counts, 0
// when no count is positive. Distinct: c < cap.
__device__ void compute_tables(const Lane& L) {
  const Tables& t = L.t;
  const int B = L.bl.b;
  const int V = L.bl.v;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
    float mn = INFINITY;
    float mx = -INFINITY;
    for (int v = lane; v < V; v += 32) {
      const float x = t.c[b * V + v];
      if (x > 0.0f) {
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      t.minc[b] = mn;
      t.maxc[b] = mx;
    }
  }
  __syncthreads();
  const size_t lane_bv = static_cast<size_t>(L.g) * B * V;
  for (int i = threadIdx.x; i < B * V; i += kThreads) {
    const int b = i / V;
    const int kind = L.kinds[b];
    const float x = t.c[i];
    float boost = 0.0f;
    int allow = 1;
    if (kind == kTargetSpread) {
      const float d = L.bl.desired[lane_bv + i];
      const float w = L.bl.weights[static_cast<size_t>(L.g) * B + b];
      boost = d > 0.0f
          ? __fmul_rn(__fdiv_rn(__fsub_rn(d, __fadd_rn(x, 1.0f)), fmaxf(d, 1e-9f)), w)
          : -1.0f;
    } else if (kind == kEvenSpread) {
      const float mn = t.minc[b];
      const float mx = t.maxc[b];
      if (mn != INFINITY) {  // some count is positive
        if (x == mn) {
          boost = mn == mx ? -1.0f : __fdiv_rn(__fsub_rn(mx, mn), fmaxf(mn, 1e-9f));
        } else {
          boost = __fdiv_rn(__fsub_rn(mn, x), fmaxf(mn, 1e-9f));
        }
      }
    } else if (kind == kDistinctCap) {
      allow = x < L.bl.caps[lane_bv + i] ? 1 : 0;
    }
    t.tbl[i] = boost;
    t.allow[i] = allow;
  }
  __syncthreads();
}

// Score of node n's head (column jn[n]) under the current tables: -inf
// where the head does not fit or a distinct cap is full.
__device__ float head_score(const Lane& L, int n) {
  const int N = L.in.n;
  const int B = L.bl.b;
  const int V = L.bl.v;
  float boost = 0.0f;
  bool allowed = true;
  for (int b = 0; b < B; ++b) {
    const int kind = L.kinds[b];
    const int v = __ldg(L.vids + static_cast<size_t>(b) * N + n);
    if (kind == kTargetSpread || kind == kEvenSpread) {
      boost = __fadd_rn(boost, v >= 0 ? L.t.tbl[b * V + v] : -1.0f);
    } else {
      boost = __fadd_rn(boost, 0.0f);
      if (kind == kDistinctCap && v >= 0 && !L.t.allow[b * V + v]) allowed = false;
    }
  }
  // the reference's head fit: column min(jn, J-1) fits and jn < J
  if (L.t.jn[n] >= L.t.jcap[n] || !allowed) return -INFINITY;
  const bool on = L.any_spread && boost != 0.0f;
  return __fdiv_rn(__fadd_rn(L.t.head_num[n], on ? boost : 0.0f),
                   __fadd_rn(static_cast<float>(L.t.head_den[n]), on ? 1.0f : 0.0f));
}

// Node n takes one more instance: its next column and that column's head.
__device__ void set_head(const Lane& L, int n, int j) {
  float den;
  candidate_terms(L.in, L.g, n, min(j, L.in.j - 1), &L.t.head_num[n], &den);
  L.t.head_den[n] = static_cast<uint8_t>(den);
}

__device__ void advance(const Lane& L, int n) {
  const int j = L.t.jn[n] + 1;
  L.t.jn[n] = static_cast<uint16_t>(j);
  set_head(L, n, j);
}

// Count the values of node n in every block.
__device__ void bump(const Lane& L, int n) {
  const int N = L.in.n;
  const int V = L.bl.v;
  for (int b = 0; b < L.bl.b; ++b) {
    const int v = __ldg(L.vids + static_cast<size_t>(b) * N + n);
    if (v >= 0) L.t.c[b * V + v] = __fadd_rn(L.t.c[b * V + v], 1.0f);
  }
}

// Lane set-up shared by the kernels: pointers, counts, node heads at
// column 0, and every output slot at -1 / -inf.
__device__ Lane setup(const Inputs& in, const Blocks& bl, unsigned char* scratch,
                      int in_smem, unsigned char* smem, int32_t* out_choices,
                      float* out_scores, size_t slots) {
  Lane L;
  L.in = in;
  L.bl = bl;
  L.g = blockIdx.x;
  const int N = in.n;
  const int B = bl.b;
  const int V = bl.v;
  const size_t g = static_cast<size_t>(L.g);
  L.t = carve(in_smem ? smem : scratch + g * region_bytes(N, B, V), N, B, V);
  L.vids = bl.value_ids + g * B * N;
  L.kinds = bl.kinds + g * B;
  L.any_spread = false;
  for (int b = 0; b < B; ++b) {
    L.any_spread |= L.kinds[b] == kTargetSpread || L.kinds[b] == kEvenSpread;
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    // j < jmax for an integer j is j < ceil(jmax); the cap is at most J
    const float jmax = feasible_columns(in, L.g, n);
    const int jcap = jmax >= static_cast<float>(in.j) ? in.j
                   : jmax > 0.0f ? static_cast<int>(ceilf(jmax)) : 0;
    L.t.jn[n] = 0;
    L.t.jcap[n] = static_cast<uint16_t>(jcap);
    set_head(L, n, 0);
  }
  for (int i = threadIdx.x; i < B * V; i += kThreads) {
    L.t.c[i] = bl.counts0[g * B * V + i];
  }
  for (size_t s = threadIdx.x; s < slots; s += kThreads) {
    out_choices[g * slots + s] = -1;
    out_scores[g * slots + s] = -INFINITY;
  }
  __syncthreads();
  return L;
}

// Chunked greedy (and, with chunk 1, the exact value scan).
__global__ void __launch_bounds__(kThreads)
chunked_kernel(Inputs in, Blocks bl, const int32_t* counts, int chunk,
               int n_chunks, unsigned char* scratch, int in_smem,
               int32_t* out_choices, float* out_scores) {
  extern __shared__ unsigned long long smem_words[];
  __shared__ unsigned long long red[kWarps + 1];
  const size_t slots = static_cast<size_t>(n_chunks) * chunk;
  const Lane L = setup(in, bl, scratch, in_smem,
                       reinterpret_cast<unsigned char*>(smem_words),
                       out_choices, out_scores, slots);
  const int N = in.n;
  const int count = counts[L.g];
  const size_t out0 = static_cast<size_t>(L.g) * slots;
  int n_placed = 0;
  for (int step = 0; step < n_chunks; ++step) {
    compute_tables(L);  // frozen for the whole chunk
    unsigned long long mine = 0ull;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const float s = head_score(L, n);
      L.t.sel[n] = s;
      const unsigned long long w = pack(s, static_cast<uint32_t>(n));
      mine = w > mine ? w : mine;
    }
    int taken = 0;
    for (int r = 0; r < chunk; ++r) {
      const unsigned long long best = block_max(mine, red);
      if (!(r + n_placed < count && packed_value(best) > -INFINITY)) break;
      ++taken;
      const int n = static_cast<int>(packed_index(best));
      if (n % kThreads == static_cast<int>(threadIdx.x)) {
        // the pick's unclamped score, then the node's next column
        out_choices[out0 + static_cast<size_t>(step) * chunk + r] = n;
        out_scores[out0 + static_cast<size_t>(step) * chunk + r] = head_score(L, n);
        bump(L, n);
        advance(L, n);
        L.t.sel[n] = fminf(L.t.sel[n], head_score(L, n));
        if (r + 1 < chunk) {  // this thread's best for the next round
          mine = 0ull;
          for (int m = threadIdx.x; m < N; m += kThreads) {
            const unsigned long long w = pack(L.t.sel[m], static_cast<uint32_t>(m));
            mine = w > mine ? w : mine;
          }
        }
      }
    }
    __syncthreads();  // counts bumped this chunk feed the next tables
    if (taken == 0) break;
    n_placed += taken;
  }
}

// One-per-value chunks for even-mode spread.
__global__ void __launch_bounds__(kThreads)
opv_kernel(Inputs in, Blocks bl, const int32_t* enforce_idx,
           const int32_t* counts, int k_seg, int n_chunks, unsigned char* scratch,
           int in_smem, int32_t* out_choices, float* out_scores) {
  extern __shared__ unsigned long long smem_words[];
  __shared__ unsigned long long red[kWarps + 1];
  __shared__ int s_rows[32];
  __shared__ int s_any_empty;
  const size_t slots = static_cast<size_t>(n_chunks) * k_seg;
  const Lane L = setup(in, bl, scratch, in_smem,
                       reinterpret_cast<unsigned char*>(smem_words),
                       out_choices, out_scores, slots);
  const Tables& t = L.t;
  const int N = in.n;
  const int V = bl.v;
  const int count = counts[L.g];
  const int eidx = enforce_idx[L.g];
  const int32_t* evids = L.vids + static_cast<size_t>(eidx) * N;
  const bool even_enforce = L.kinds[eidx] == kEvenSpread;
  const size_t out0 = static_cast<size_t>(L.g) * slots;
  const auto seg_of = [&](int n) { return evids[n] >= 0 ? evids[n] : V; };

  // enforce-block values held by at least one eligible node: V is padded
  // to a power of two, and a phantom value must not read as empty
  for (int v = threadIdx.x; v < V; v += kThreads) t.present[v] = 0;
  __syncthreads();
  const uint8_t* elig = in.eligible + static_cast<size_t>(L.g) * N;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    if (elig[n] && evids[n] >= 0) t.present[evids[n]] = 1;
  }
  __syncthreads();

  int n_placed = 0;
  for (int step = 0; step < n_chunks; ++step) {
    if (threadIdx.x == 0) s_any_empty = 0;
    // first pick with the frozen tables
    compute_tables(L);
    unsigned long long mine = 0ull;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const unsigned long long w = pack(head_score(L, n), static_cast<uint32_t>(n));
      mine = w > mine ? w : mine;
    }
    const unsigned long long best = block_max(mine, red);
    const float score0 = packed_value(best);
    const bool ok0 = score0 > -INFINITY && n_placed < count;
    if (!ok0) break;
    const int first = static_cast<int>(packed_index(best));
    const int v_first = seg_of(first);
    if (threadIdx.x == 0) {
      out_choices[out0 + static_cast<size_t>(step) * k_seg] = first;
      out_scores[out0 + static_cast<size_t>(step) * k_seg] = score0;
      s_rows[0] = first;
      bump(L, first);
    }
    __syncthreads();
    compute_tables(L);  // re-derived after the first pick

    // rotation guard over the enforced block's counts after the bump
    const float* ec = t.c + static_cast<size_t>(eidx) * V;
    const float minc1 = t.minc[eidx];
    const float maxc1 = t.maxc[eidx];
    for (int v = threadIdx.x; v < V; v += kThreads) {
      if (!(ec[v] > 0.0f) && t.present[v]) s_any_empty = 1;
    }
    for (int s = threadIdx.x; s <= V; s += kThreads) t.seg_best[s] = 0ull;
    __syncthreads();
    const bool no_empty = s_any_empty == 0;
    for (int v = threadIdx.x; v < V; v += kThreads) {
      const bool pos1 = ec[v] > 0.0f;
      const bool rotate_ok = no_empty
          ? pos1 && ec[v] <= minc1 && maxc1 > minc1
          : !pos1 && t.present[v];
      t.seg_ok[v] = (!even_enforce || rotate_ok) ? 1 : 0;
    }
    if (threadIdx.x == 0) t.seg_ok[V] = 1;  // value-less nodes
    // per-segment max of the re-derived scores, first's segment excluded
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const int s = seg_of(n);
      const float s1 = s == v_first ? -INFINITY : head_score(L, n);
      atomicMax(&t.seg_best[s], pack(s1, static_cast<uint32_t>(n)));
    }
    __syncthreads();

    // top (k_seg - 1) segments, value desc then segment asc
    int taken = 1;
    for (int r = 0; r < k_seg - 1; ++r) {
      unsigned long long mine_s = 0ull;
      for (int s = threadIdx.x; s <= V; s += kThreads) {
        const float val = t.seg_ok[s] && t.seg_best[s] != 0ull
            ? packed_value(t.seg_best[s]) : -INFINITY;
        const unsigned long long w = pack(val, static_cast<uint32_t>(s));
        mine_s = w > mine_s ? w : mine_s;
      }
      const unsigned long long top = block_max(mine_s, red);
      const float val = packed_value(top);
      if (!(r + n_placed + 1 < count && val > -INFINITY)) break;
      const int s = static_cast<int>(packed_index(top));
      const int row = static_cast<int>(packed_index(t.seg_best[s]));
      if (s % kThreads == static_cast<int>(threadIdx.x)) t.seg_ok[s] = 0;
      if (threadIdx.x == 0) {
        const size_t slot = out0 + static_cast<size_t>(step) * k_seg + 1 + r;
        out_choices[slot] = row;
        out_scores[slot] = val;
        s_rows[1 + r] = row;
        bump(L, row);
      }
      ++taken;
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < taken) advance(L, s_rows[threadIdx.x]);
    n_placed += taken;
    __syncthreads();
  }
}

// Dynamic shared memory each kernel may take: the card's opt-in maximum
// less the kernel's static shared memory, granted once per process by a
// thread-safe static (the launchers run with the GIL released), and never
// inside a CUDA graph capture: the first launch is an ordinary one.
struct SmemGrant {
  int error;
  size_t chunked;
  size_t opv;
};

cudaError_t grant(const void* kernel, int optin, size_t* room) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*room));
}

int smem_limit(const void* kernel, size_t* limit) {
  static const SmemGrant granted = [] {
    SmemGrant out{0, 0, 0};
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) {
      e = grant(reinterpret_cast<const void*>(chunked_kernel), optin, &out.chunked);
    }
    if (e == cudaSuccess) {
      e = grant(reinterpret_cast<const void*>(opv_kernel), optin, &out.opv);
    }
    out.error = static_cast<int>(e);
    return out;
  }();
  *limit = kernel == reinterpret_cast<const void*>(opv_kernel) ? granted.opv
                                                               : granted.chunked;
  return granted.error;
}

// The lane region goes to shared memory when it fits, else to the
// caller's global scratch: sets the dynamic shared memory to launch with
// and the scratch bytes each lane needs (one of them 0).
int plan_region(const void* kernel, int n, int b, int v, size_t* smem,
                size_t* scratch_bytes) {
  size_t limit = 0;
  const int e = smem_limit(kernel, &limit);
  if (e != 0) return e;
  const size_t bytes = region_bytes(n, b, v);
  *smem = bytes <= limit ? bytes : 0;
  *scratch_bytes = bytes <= limit ? 0 : bytes;
  return 0;
}

const void* kernel_of(int opv) {
  return opv ? reinterpret_cast<const void*>(opv_kernel)
             : reinterpret_cast<const void*>(chunked_kernel);
}

// Plans one launch; refuses a region that needs scratch when none is given.
int plan_launch(int opv, int n, int b, int v, const unsigned char* scratch,
                size_t* smem, int* in_smem) {
  size_t scratch_bytes = 0;
  const int e = plan_region(kernel_of(opv), n, b, v, smem, &scratch_bytes);
  if (e != 0) return e;
  if (scratch_bytes > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  *in_smem = scratch_bytes == 0 ? 1 : 0;
  return 0;
}

}  // namespace

// C entry points, bound with ctypes (nomad_tpu_torch/device/score.py).
// Each launches on `stream`, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported to the caller.
// Scratch: the bytes per lane that nomad_coupled_scratch_bytes sets, 0
// where the lane's region fits in shared memory (scratch may then be
// null); `opv` selects the one-per-value kernel, else the chunked one.

extern "C" int nomad_coupled_scratch_bytes(int opv, int n, int b, int v,
                                           size_t* bytes) {
  size_t smem = 0;
  return plan_region(kernel_of(opv), n, b, v, &smem, bytes);
}

#define NOMAD_COUPLED_PARAMS                                                   \
  const float *capacity, const float *used0, const float *asks,               \
      const uint8_t *eligible, const int32_t *job_counts,                      \
      const float *desired_totals, const uint8_t *penalty,                     \
      const float *affinity, const uint8_t *has_aff, const uint8_t *distinct,  \
      const float *slot_caps, const int32_t *value_ids, const float *counts0,  \
      const float *desired, const float *caps, const float *weights,           \
      const int32_t *kinds, const float *jitter, const int32_t *counts,        \
      int algorithm_spread, int g, int n, int j, int b, int v

#define NOMAD_COUPLED_STRUCTS                                                  \
  Inputs in{capacity, used0,     asks,     eligible, job_counts,              \
            desired_totals, penalty, affinity, has_aff,  distinct,            \
            slot_caps, jitter, algorithm_spread, n, j};                        \
  Blocks bl{value_ids, counts0, desired, caps, weights, kinds, b, v};

extern "C" int nomad_place_value_scan(
    NOMAD_COUPLED_PARAMS, int max_steps, unsigned char* scratch,
    int32_t* out_choices, float* out_scores, void* stream) {
  NOMAD_COUPLED_STRUCTS
  size_t smem = 0;
  int in_smem = 0;
  const int e = plan_launch(0, n, b, v, scratch, &smem, &in_smem);
  if (e != 0) return e;
  chunked_kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, bl, counts, 1, max_steps, scratch, in_smem, out_choices, out_scores);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nomad_place_spread_chunked(
    NOMAD_COUPLED_PARAMS, int chunk, int n_chunks, unsigned char* scratch,
    int32_t* out_choices, float* out_scores, void* stream) {
  NOMAD_COUPLED_STRUCTS
  size_t smem = 0;
  int in_smem = 0;
  const int e = plan_launch(0, n, b, v, scratch, &smem, &in_smem);
  if (e != 0) return e;
  chunked_kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, bl, counts, chunk, n_chunks, scratch, in_smem, out_choices, out_scores);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nomad_place_spread_opv(
    NOMAD_COUPLED_PARAMS, const int32_t* enforce_idx, int k_seg, int n_chunks,
    unsigned char* scratch, int32_t* out_choices, float* out_scores,
    void* stream) {
  NOMAD_COUPLED_STRUCTS
  size_t smem = 0;
  int in_smem = 0;
  const int e = plan_launch(1, n, b, v, scratch, &smem, &in_smem);
  if (e != 0) return e;
  opv_kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, bl, enforce_idx, counts, k_seg, n_chunks, scratch, in_smem,
      out_choices, out_scores);
  return static_cast<int>(cudaGetLastError());
}
