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
// a pass over all nodes, a block-wide reduction and a few barriers. In
// the one-block form the pass dominates: each thread reads its 16 nodes'
// value ids from L2 one after another (~10 us a pass at 16,384 nodes,
// from the measured step times in PERF.md), then a round costs ~2 us.
// So every kernel runs a lane over a thread-block cluster with its value
// ids on chip where its state fits (below), and one block a lane where
// it does not.
//
// Design: the one-block form is one 1,024-thread block per lane (the
// value scan, the chunked scan and the one-per-value kernel; the cluster
// forms below share compute_tables, block_max and candidate.cuh with
// them), the whole scan inside the launch, no [N, J] plane anywhere.
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
//  - One-per-value, one-block form (V + 1 > 1,024, or a share of the
//    cluster too large for shared memory: the wide_values call's V
//    16,384): segment maxima by 64-bit integer atomicMax on (order key,
//    ~row) words -- integer, so the result does not depend on the order
//    of the atomics -- then k_seg - 1 rounds of block argmax over the V +
//    1 segments, behind the rotation guard.
//  - One-per-value, cluster form (opv_cluster_kernel): a lane is a
//    cluster of 8 blocks (the portable size: every H100 GPC holds 8 free
//    SMs, and at the spread path's 16,384 nodes 8 slices already leave
//    each thread two nodes, so 16 would halve a pass that is no longer
//    what a step waits on while its cluster barriers cost more), each
//    block over a slice of N / 8 nodes whose head state and value ids
//    (+1, in uint8 up to V + 1 = 256, else uint16) it stages once in its
//    shared memory. The count state and tables are replicated: every
//    block applies the same picks in the same order, so the copies stay
//    identical. A step: each block's best first pick, one cluster
//    barrier, every warp reads the 8 words through distributed shared
//    memory; the bump and the re-derived tables; each block's segment
//    maxima (the lanes of a warp on one segment reduce together:
//    __match_any_sync, then the 64-bit max as two 32-bit
//    __reduce_max_sync, one shared atomicMax a segment onto the warp's
//    partial table), the partial tables merged, a second cluster
//    barrier, and each block merges the 8 blocks' maxima. The top
//    (k_seg - 1) allowed segments are then one selection: each
//    candidate segment's rank among the candidates' (value, segment)
//    words is its pick's place, which keeps the round-by-round loop's
//    order and its count and -inf stops (seg_best never changes inside
//    the loop; a round only clears the segment it took). Each pick's
//    head moves on in the block that owns it. Two cluster barriers a
//    step; no global scratch.
//  - Chunked and value scan, cluster form (chunked_cluster_kernel): the
//    same slices, staged value ids and replicated count state. A chunk's
//    top CHUNK entries of the plane, by (value desc, node asc, column
//    asc), are the top CHUNK of the union of each slice's own top CHUNK:
//    the slices are disjoint and a node's clamped sequence is
//    non-increasing, so its next column enters only after its current
//    one. Each block finds its slice's top entries on its own, without a
//    block-wide round a pick: they come from the nodes whose heads are
//    among the slice's top CHUNK, so the warps take their own top heads,
//    warp 0 merges them, every candidate's next columns are scored at
//    once and clamped, and warp 0 merges those column lists. Then one
//    cluster barrier, and every block merges the 8 sorted walks into the
//    same picks: each entry's place is its rank in its own walk plus the
//    entries of the other walks above it, and it is taken below the
//    lane's count. Each block moves the heads of the nodes its taken
//    entries came from, and counts every pick's values (staged beside
//    the walk) in merge order. With chunks of one (the value scan) a walk
//    is the slice's best head. One cluster barrier a step.
//  - A step that takes nothing leaves the state unchanged, so every later
//    step would take nothing too: the scan stops there.
//
// Numerics: candidate.cuh's (IEEE division, expf, -fmad=false). No float
// atomics; every float sum runs in the reference's order.

#include <cooperative_groups.h>

#include <utility>
#include <vector>

#include "candidate.cuh"
#include "cluster.cuh"

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

// Warp-wide max of one word per lane, as two 32-bit reductions: the
// high words, then the low words of the lanes at the highest.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
  const uint32_t hi = __reduce_max_sync(0xffffffffu, static_cast<uint32_t>(x >> 32));
  const uint32_t lo = __reduce_max_sync(
      0xffffffffu, static_cast<uint32_t>(x >> 32) == hi ? static_cast<uint32_t>(x) : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Block-wide max of one word per thread; every thread gets the result.
__device__ unsigned long long block_max(unsigned long long x,
                                        unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_max(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = warp_max(lane < kWarps ? red[lane] : 0ull);
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

// Columns of lane g's ask that fit on node n: column j fits iff j < the
// cap. j < jmax for an integer j is j < ceil(jmax); the cap is at most J.
__device__ int column_cap(const Inputs& in, int g, int n) {
  const float jmax = feasible_columns(in, g, n);
  return jmax >= static_cast<float>(in.j) ? in.j
       : jmax > 0.0f ? static_cast<int>(ceilf(jmax)) : 0;
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
    L.t.jn[n] = 0;
    L.t.jcap[n] = static_cast<uint16_t>(column_cap(in, L.g, n));
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

// -- one-per-value over a thread-block cluster --------------------------------

constexpr int kCluster = 8;             // blocks a lane (portable cluster size)
constexpr int kMaxSegments = kThreads;  // V + 1: one thread a segment
constexpr int kMaxPicks = 16;           // k_seg (the wrapper's CHUNK)
constexpr size_t kPartialBytes = 32 * 1024;

__host__ __device__ int cluster_slice(int n) { return (n + kCluster - 1) / kCluster; }

// Partial tables of the segments' largest score keys a block keeps, one
// a warp (warps share one when V is wide), so that only the lanes of a
// warp contend for a segment's word.
__host__ __device__ int cluster_partials(int v) {
  int p = kWarps;
  while (p > 1 && static_cast<size_t>(p) * (v + 1) * 4 > kPartialBytes) p >>= 1;
  return p;
}

// Dynamic shared memory of one cluster block: the segment words (the
// block's maxima read by the cluster, the candidate words), the
// replicated count state and tables, the segment keys (partial tables,
// largest keys, lowest nodes), and the block's node slice (head state,
// this pass's scores and the value ids in `id_bytes` a value).
__host__ __device__ size_t cluster_bytes(int n, int b, int v, int id_bytes) {
  const size_t s = static_cast<size_t>(v) + 1;
  const size_t bv = static_cast<size_t>(b) * v;
  const size_t ns = cluster_slice(n);
  const size_t bytes = 8 * 2 * s +
                       4 * (2 * bv + 2 * static_cast<size_t>(b) + 2 * ns) +
                       4 * (bv + 4 * s + v + b + cluster_partials(v) * s) +
                       2 * 2 * ns + static_cast<size_t>(id_bytes) * b * ns + ns;
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// A block's slice of its lane's nodes, [lo, lo + len), in shared memory.
template <typename VT>
struct Slice {
  float* head_num;    // [ns] numerator at column jn
  uint16_t* jn;       // [ns]
  uint16_t* jcap;     // [ns]
  VT* vids;           // [B, ns] value id + 1, 0 = no value
  uint8_t* head_den;  // [ns]
  int lo;
  int len;
  int ns;
};

// A slice node's summed spread boost under the current tables, and
// whether its distinct caps allow it (head_score's block loop, on the
// slice's shared copy of the value ids and block kinds).
template <typename VT>
__device__ bool slice_terms(const Lane& L, const Slice<VT>& sl, const int32_t* kinds, int i,
                            float* boost_out) {
  const int B = L.bl.b;
  const int V = L.bl.v;
  float boost = 0.0f;
  bool allowed = true;
  for (int b = 0; b < B; ++b) {
    const int kind = kinds[b];
    const int v = static_cast<int>(sl.vids[static_cast<size_t>(b) * sl.ns + i]) - 1;
    if (kind == kTargetSpread || kind == kEvenSpread) {
      boost = __fadd_rn(boost, v >= 0 ? L.t.tbl[b * V + v] : -1.0f);
    } else {
      boost = __fadd_rn(boost, 0.0f);
      if (kind == kDistinctCap && v >= 0 && !L.t.allow[b * V + v]) allowed = false;
    }
  }
  *boost_out = boost;
  return allowed;
}

// The score of numerator / denominator with the node's boost (head_score).
__device__ __forceinline__ float boosted(const Lane& L, float num, float den, float boost) {
  const bool on = L.any_spread && boost != 0.0f;
  return __fdiv_rn(__fadd_rn(num, on ? boost : 0.0f), __fadd_rn(den, on ? 1.0f : 0.0f));
}

// head_score on the slice's shared state.
template <typename VT>
__device__ float slice_score(const Lane& L, const Slice<VT>& sl, const int32_t* kinds,
                             int i) {
  float boost;
  const bool allowed = slice_terms(L, sl, kinds, i, &boost);
  if (sl.jn[i] >= sl.jcap[i] || !allowed) return -INFINITY;
  return boosted(L, sl.head_num[i], static_cast<float>(sl.head_den[i]), boost);
}

// The score of a slice node's column j under the current tables (-inf
// where it does not fit or a cap is full): slice_score at jn = j.
template <typename VT>
__device__ float column_score(const Lane& L, const Slice<VT>& sl, const int32_t* kinds, int i,
                              int j) {
  float boost;
  const bool allowed = slice_terms(L, sl, kinds, i, &boost);
  if (j >= sl.jcap[i] || !allowed) return -INFINITY;
  float num, den;
  candidate_terms(L.in, L.g, sl.lo + i, min(j, L.in.j - 1), &num, &den);
  return boosted(L, num, den, boost);
}

template <typename VT>
__device__ void slice_head(const Lane& L, const Slice<VT>& sl, int i, int j) {
  float den;
  candidate_terms(L.in, L.g, sl.lo + i, min(j, L.in.j - 1), &sl.head_num[i], &den);
  sl.head_den[i] = static_cast<uint8_t>(den);
}

// One-per-value chunks for even-mode spread, a lane a cluster of
// kCluster blocks, each over its slice of the nodes.
template <typename VT>
__global__ void __launch_bounds__(kThreads)
opv_cluster_kernel(Inputs in, Blocks bl, const int32_t* enforce_idx,
                   const int32_t* counts, int k_seg, int n_chunks,
                   int32_t* out_choices, float* out_scores) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned long long smem_words[];
  __shared__ unsigned long long red[kWarps + 1];
  __shared__ unsigned long long s_first;  // the block's best first pick, read by the cluster
  __shared__ int s_first_seg;             // its enforce-block segment, read by the cluster
  __shared__ int s_rows[kMaxPicks];
  __shared__ int s_segs[kMaxPicks];
  __shared__ float s_vals[kMaxPicks];
  __shared__ int s_any_empty;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = in.n;
  const int B = bl.b;
  const int V = bl.v;
  const int S = V + 1;
  const int P = cluster_partials(V);
  const size_t bv = static_cast<size_t>(B) * V;

  Lane L;
  L.in = in;
  L.bl = bl;
  L.g = static_cast<int>(blockIdx.x) / kCluster;
  const size_t g = static_cast<size_t>(L.g);
  L.vids = bl.value_ids + g * B * N;
  L.kinds = bl.kinds + g * B;
  L.any_spread = false;
  for (int b = 0; b < B; ++b) {
    L.any_spread |= L.kinds[b] == kTargetSpread || L.kinds[b] == kEvenSpread;
  }
  Slice<VT> sl;
  sl.ns = cluster_slice(N);
  sl.lo = rank * sl.ns;
  sl.len = max(0, min(N - sl.lo, sl.ns));
  unsigned long long* seg_loc = smem_words;  // [S]
  unsigned long long* cw = seg_loc + S;     // [S]
  float* f = reinterpret_cast<float*>(cw + S);
  L.t.c = f;
  L.t.tbl = f + bv;
  L.t.minc = f + 2 * bv;
  L.t.maxc = f + 2 * bv + B;
  sl.head_num = f + 2 * bv + 2 * B;
  float* score1 = sl.head_num + sl.ns;      // [ns] this pass's scores
  int32_t* ip = reinterpret_cast<int32_t*>(score1 + sl.ns);
  L.t.allow = ip;
  int32_t* seg_ok = ip + bv;
  int32_t* present = seg_ok + S;
  int32_t* crow = present + V;
  int32_t* kinds = crow + S;
  uint32_t* part = reinterpret_cast<uint32_t*>(kinds + B);  // [P, S]
  uint32_t* seg_key = part + static_cast<size_t>(P) * S;     // [S]
  uint32_t* seg_low = seg_key + S;                           // [S]
  sl.jn = reinterpret_cast<uint16_t*>(seg_low + S);
  sl.jcap = sl.jn + sl.ns;
  sl.vids = reinterpret_cast<VT*>(sl.jcap + sl.ns);
  sl.head_den = reinterpret_cast<uint8_t*>(sl.vids + static_cast<size_t>(B) * sl.ns);

  // set-up: the slice's heads at column 0 and value ids, the replicated
  // counts, and (block 0) every output slot at -1 / -inf
  const size_t slots = static_cast<size_t>(n_chunks) * k_seg;
  const size_t out0 = g * slots;
  for (int b = tid; b < B; b += kThreads) kinds[b] = L.kinds[b];
  for (int i = tid; i < sl.len; i += kThreads) {
    const int n = sl.lo + i;
    sl.jn[i] = 0;
    sl.jcap[i] = static_cast<uint16_t>(column_cap(in, L.g, n));
    slice_head(L, sl, i, 0);
    for (int b = 0; b < B; ++b) {
      sl.vids[static_cast<size_t>(b) * sl.ns + i] =
          static_cast<VT>(L.vids[static_cast<size_t>(b) * N + n] + 1);
    }
  }
  for (size_t i = tid; i < bv; i += kThreads) L.t.c[i] = bl.counts0[g * bv + i];
  for (int v = tid; v < V; v += kThreads) present[v] = 0;
  if (rank == 0) {
    for (size_t s = tid; s < slots; s += kThreads) {
      out_choices[out0 + s] = -1;
      out_scores[out0 + s] = -INFINITY;
    }
  }
  const int count = counts[L.g];
  const int eidx = enforce_idx[L.g];
  const int32_t* evids = L.vids + static_cast<size_t>(eidx) * N;
  const bool even_enforce = L.kinds[eidx] == kEvenSpread;
  const VT* my_evids = sl.vids + static_cast<size_t>(eidx) * sl.ns;
  __syncthreads();
  L.kinds = kinds;  // compute_tables reads the shared copy from now on
  // enforce-block values held by at least one eligible node (over every
  // node, in every block)
  const uint8_t* elig = in.eligible + g * N;
  for (int n = tid; n < N; n += kThreads) {
    if (elig[n] && evids[n] >= 0) present[evids[n]] = 1;
  }
  __syncthreads();

  int n_placed = 0;
  for (int step = 0; step < n_chunks; ++step) {
    if (tid == 0) s_any_empty = 0;
    // first pick with the frozen tables: each block's best, then the
    // cluster's through distributed shared memory
    compute_tables(L);
    unsigned long long mine = 0ull;
    for (int i = tid; i < sl.len; i += kThreads) {
      const unsigned long long w =
          pack(slice_score(L, sl, kinds, i), static_cast<uint32_t>(sl.lo + i));
      mine = w > mine ? w : mine;
    }
    const unsigned long long local = block_max(mine, red);
    if (tid == 0) {
      s_first = local;
      const int i = static_cast<int>(packed_index(local)) - sl.lo;
      s_first_seg = local != 0ull ? static_cast<int>(my_evids[i]) - 1 : -1;
    }
    cluster.sync();
    // lanes 0-7 read the blocks' words, lanes 8-15 their segments
    unsigned long long best = 0ull;
    int seg = 0;
    if (lane < kCluster) best = *cluster.map_shared_rank(&s_first, lane);
    if (lane >= kCluster && lane < 2 * kCluster) {
      seg = *cluster.map_shared_rank(&s_first_seg, lane - kCluster);
    }
    const unsigned long long mine_best = best;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long y = __shfl_xor_sync(0xffffffffu, best, o);
      best = y > best ? y : best;
    }
    const int owner = __ffs(__ballot_sync(0xffffffffu, lane < kCluster && mine_best == best)) - 1;
    const int ev_first = __shfl_sync(0xffffffffu, seg, kCluster + owner);
    const float score0 = packed_value(best);
    if (!(score0 > -INFINITY && n_placed < count)) break;
    const int first = static_cast<int>(packed_index(best));
    const int v_first = ev_first >= 0 ? ev_first : V;
    if (rank == 0 && tid == 0) {
      out_choices[out0 + static_cast<size_t>(step) * k_seg] = first;
      out_scores[out0 + static_cast<size_t>(step) * k_seg] = score0;
    }
    // the first pick's values counted: the enforce block's is its
    // segment, the other blocks' are read
    for (int b = tid; b < B; b += kThreads) {
      const int v = b == eidx ? ev_first : L.vids[static_cast<size_t>(b) * N + first];
      if (v >= 0) L.t.c[b * V + v] = __fadd_rn(L.t.c[b * V + v], 1.0f);
    }
    __syncthreads();
    compute_tables(L);  // re-derived after the first pick

    // rotation guard over the enforced block's counts after the bump
    const float* ec = L.t.c + static_cast<size_t>(eidx) * V;
    const float minc1 = L.t.minc[eidx];
    const float maxc1 = L.t.maxc[eidx];
    for (int v = tid; v < V; v += kThreads) {
      if (!(ec[v] > 0.0f) && present[v]) s_any_empty = 1;
    }
    for (size_t s = tid; s < static_cast<size_t>(P) * S; s += kThreads) part[s] = 0u;
    __syncthreads();
    const bool no_empty = s_any_empty == 0;
    for (int v = tid; v < V; v += kThreads) {
      const bool pos1 = ec[v] > 0.0f;
      const bool rotate_ok = no_empty
          ? pos1 && ec[v] <= minc1 && maxc1 > minc1
          : !pos1 && present[v];
      seg_ok[v] = (!even_enforce || rotate_ok) ? 1 : 0;
    }
    if (tid == 0) seg_ok[V] = 1;  // value-less nodes
    // per-segment max of the re-derived scores (first's segment
    // excluded) as a 64-bit (order key, ~row) word, in two passes of
    // native 32-bit shared atomics: the largest key (onto the warp's
    // partial table), then the lowest row at that key
    uint32_t* mytable = part + static_cast<size_t>(warp % P) * S;
    for (int i = tid; i < sl.len; i += kThreads) {
      const int ev = static_cast<int>(my_evids[i]) - 1;
      const int s = ev >= 0 ? ev : V;
      const float s1 = s == v_first ? -INFINITY : slice_score(L, sl, kinds, i);
      score1[i] = s1;
      atomicMax(&mytable[s], order_key(s1));
    }
    __syncthreads();
    for (int s = tid; s < S; s += kThreads) {
      uint32_t m = 0u;
      for (int p = 0; p < P; ++p) m = max(m, part[static_cast<size_t>(p) * S + s]);
      seg_key[s] = m;
      seg_low[s] = 0u;
    }
    __syncthreads();
    for (int i = tid; i < sl.len; i += kThreads) {
      const int ev = static_cast<int>(my_evids[i]) - 1;
      const int s = ev >= 0 ? ev : V;
      if (order_key(score1[i]) == seg_key[s]) {
        atomicMax(&seg_low[s], 0xffffffffu - static_cast<uint32_t>(sl.lo + i));
      }
    }
    __syncthreads();
    for (int s = tid; s < S; s += kThreads) {
      // a segment without a node in this slice keeps key 0 (every order
      // key of a score is above 0)
      seg_loc[s] = seg_key[s] == 0u
          ? 0ull
          : (static_cast<unsigned long long>(seg_key[s]) << 32) | seg_low[s];
    }
    cluster.sync();

    // the cluster's segment maxima; the top (k_seg - 1) allowed segments,
    // value desc then segment asc, by each candidate's rank among them
    bool cand = false;
    float val = -INFINITY;
    if (tid < S) {
      unsigned long long m = 0ull;
      for (int r = 0; r < kCluster; ++r) {
        const unsigned long long y = cluster.map_shared_rank(seg_loc, r)[tid];
        m = y > m ? y : m;
      }
      val = seg_ok[tid] && m != 0ull ? packed_value(m) : -INFINITY;
      cand = val > -INFINITY;
      cw[tid] = cand ? pack(val, static_cast<uint32_t>(tid)) : 0ull;
      crow[tid] = static_cast<int>(packed_index(m));
    }
    const int ncand = __syncthreads_count(cand);
    const int limit = max(0, min(min(k_seg - 1, ncand), count - n_placed - 1));
    if (cand) {
      const unsigned long long me = cw[tid];
      int above = 0;
      for (int s = 0; s < S; ++s) above += cw[s] > me ? 1 : 0;
      if (above < limit) {
        s_rows[above] = crow[tid];
        s_segs[above] = tid;
        s_vals[above] = val;
      }
    }
    __syncthreads();
    if (rank == 0 && tid < limit) {
      const size_t slot = out0 + static_cast<size_t>(step) * k_seg + 1 + tid;
      out_choices[slot] = s_rows[tid];
      out_scores[slot] = s_vals[tid];
    }
    // the picks' values counted in every block by warps 1 on, beside
    // the heads' moves in warp 0: the enforce block's value is the
    // pick's segment, the other blocks' loads are issued at once
    for (int b = tid - 32; b >= 0 && b < B; b += kThreads - 32) {
      int vv[kMaxPicks];
#pragma unroll
      for (int r = 0; r < kMaxPicks; ++r) {
        vv[r] = r >= limit ? -1
              : b == eidx ? (s_segs[r] < V ? s_segs[r] : -1)
              : L.vids[static_cast<size_t>(b) * N + s_rows[r]];
      }
#pragma unroll
      for (int r = 0; r < kMaxPicks; ++r) {
        if (vv[r] >= 0) L.t.c[b * V + vv[r]] = __fadd_rn(L.t.c[b * V + vv[r]], 1.0f);
      }
    }
    // each pick's owner block moves its head on
    if (tid <= limit) {
      const int row = tid == 0 ? first : s_rows[tid - 1];
      const int i = row - sl.lo;
      if (i >= 0 && i < sl.len) {
        const int j = sl.jn[i] + 1;
        sl.jn[i] = static_cast<uint16_t>(j);
        slice_head(L, sl, i, j);
      }
    }
    n_placed += 1 + limit;
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may read its shared memory
}

// -- chunked scan (and value scan) over a thread-block cluster ---------------

constexpr int kMaxChunk = kMaxPicks;  // chunk (the wrapper's CHUNK; 1 for the value scan)
constexpr int kWalkWords = kCluster * kMaxChunk;
constexpr int kColumns = kMaxChunk * kMaxChunk;  // the candidates' next columns

// Entry words of the clamped plane, ordered as the reference's top-k over
// it: value desc, then node asc, then column asc (k counts columns from
// the node's next one). Words of two nodes never tie.
__device__ __forceinline__ unsigned long long pack_column(float value, int node, int k) {
  return pack(value, static_cast<uint32_t>(node) * kMaxChunk + k);
}
__device__ __forceinline__ int column_node(unsigned long long w) {
  return static_cast<int>(packed_index(w) / kMaxChunk);
}
__device__ __forceinline__ int column_k(unsigned long long w) {
  return static_cast<int>(packed_index(w) % kMaxChunk);
}

// Warp 0 merges up to 32 sorted lists of words (list l at lists[l *
// kMaxChunk], 0 past its end) into their top `want`: lane l holds list
// l's head. Calls take(lane's list, its position, round) on the lane whose
// head each round takes; returns the words taken.
template <typename Take>
__device__ int warp_merge(const unsigned long long* lists, int n_lists, int want, Take take) {
  const int lane = threadIdx.x & 31;
  int p = 0;
  unsigned long long head = lane < n_lists ? lists[lane * kMaxChunk] : 0ull;
  int len = 0;
  for (int r = 0; r < want; ++r) {
    const unsigned long long top = warp_max(head);
    if (top == 0ull) break;
    len = r + 1;
    if (head == top) {
      take(lane, p, r);
      ++p;
      head = p < kMaxChunk ? lists[lane * kMaxChunk + p] : 0ull;
    }
  }
  return len;
}

// Dynamic shared memory of one chunked_cluster_kernel block: the
// replicated count state and tables, the block's node slice (head state,
// this chunk's heads and the value ids in `id_bytes` a value), and the
// value ids of each walk entry's node, by step parity.
__host__ __device__ size_t chunked_cluster_bytes(int n, int b, int v, int id_bytes) {
  const size_t bv = static_cast<size_t>(b) * v;
  const size_t ns = cluster_slice(n);
  const size_t bytes = 4 * (3 * bv + 3 * static_cast<size_t>(b) + 2 * ns) + 2 * 2 * ns +
                       static_cast<size_t>(id_bytes) * b * (ns + 2 * kMaxChunk) + ns;
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// Chunked greedy (and, with chunk 1, the exact value scan), a lane a
// cluster of kCluster blocks, each over its slice of the nodes.
//
// Every block holds the same count state and tables: each block starts
// from the lane's counts0, derives the tables with the same code, and
// counts the same picks in the same order, so the copies agree bit for
// bit and every block takes the same decisions (picks, stops, breaks)
// without telling the others. Only the walks cross blocks.
//
// A block's walk is its slice's top `want` entries of the clamped plane.
// They come only from the nodes whose heads are among the slice's top
// `want` heads (each of those heads lies above every entry of a node
// outside them), so: each warp takes its own nodes' heads among those
// (rounds of warp max, down to the want-th largest of the warps' best
// heads), warp 0 merges the 32 warps' lists into the slice's, every
// candidate's next `want` columns are scored at once and clamped by their
// running minimum, and warp 0 merges the candidates' column lists into
// the walk. No round waits on a column's arithmetic.
//
// One cluster barrier a step is enough because each block's walk buffers
// are double-buffered by step parity: the cluster reads step s's walks
// after barrier s and before it arrives at barrier s + 1, and no block
// writes those buffers again before step s + 2, which it starts only
// after barrier s + 1.
template <typename VT>
__global__ void __launch_bounds__(kThreads)
chunked_cluster_kernel(Inputs in, Blocks bl, const int32_t* counts, int chunk, int n_chunks,
                       int32_t* out_choices, float* out_scores) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned long long smem_words[];
  // per step, by phase: the warps' head lists [kWarps][kMaxChunk]; the
  // candidates' column words [kColumns] and unclamped scores [kColumns];
  // the cluster's walks [kWalkWords]
  __shared__ unsigned long long s_scratch[kWarps * kMaxChunk];
  // this block's walk (entry words, 0 past its end) by step parity, read
  // by the cluster, and each entry's unclamped score
  __shared__ unsigned long long s_walk[2][kMaxChunk];
  __shared__ float s_raw[kMaxChunk];
  __shared__ unsigned long long s_top[kMaxChunk];  // the slice's top heads
  __shared__ unsigned long long s_floor;  // the want-th largest of the warps' best heads
  __shared__ int s_ntop;
  __shared__ int s_src[kMaxChunk];  // the step's picks in merge order: b * kMaxChunk + entry
  __shared__ uint8_t s_kept[kMaxChunk];  // the merge took this entry of the walk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = in.n;
  const int B = bl.b;
  const int V = bl.v;
  const size_t bv = static_cast<size_t>(B) * V;
  unsigned long long* heads = s_scratch;                                     // phase 1-2
  unsigned long long* col_words = s_scratch;                                 // phase 3-4
  float* col_raw = reinterpret_cast<float*>(s_scratch + kColumns);           // phase 3-4
  unsigned long long* s_all = s_scratch;                                     // the merge

  Lane L;
  L.in = in;
  L.bl = bl;
  L.g = static_cast<int>(blockIdx.x) / kCluster;
  const size_t g = static_cast<size_t>(L.g);
  L.vids = bl.value_ids + g * B * N;
  L.kinds = bl.kinds + g * B;
  L.any_spread = false;
  for (int b = 0; b < B; ++b) {
    L.any_spread |= L.kinds[b] == kTargetSpread || L.kinds[b] == kEvenSpread;
  }
  Slice<VT> sl;
  sl.ns = cluster_slice(N);
  sl.lo = rank * sl.ns;
  sl.len = max(0, min(N - sl.lo, sl.ns));
  float* f = reinterpret_cast<float*>(smem_words);
  L.t.c = f;
  L.t.tbl = f + bv;
  L.t.minc = f + 2 * bv;
  L.t.maxc = f + 2 * bv + B;
  sl.head_num = f + 2 * bv + 2 * B;
  float* sel = sl.head_num + sl.ns;  // [ns] this chunk's head scores
  int32_t* ip = reinterpret_cast<int32_t*>(sel + sl.ns);
  L.t.allow = ip;
  int32_t* kinds = ip + bv;
  sl.jn = reinterpret_cast<uint16_t*>(kinds + B);
  sl.jcap = sl.jn + sl.ns;
  sl.vids = reinterpret_cast<VT*>(sl.jcap + sl.ns);
  // [2][kMaxChunk][B]: the staged value ids of each walk entry's node,
  // read by the cluster with the walk
  VT* walk_vids = sl.vids + static_cast<size_t>(B) * sl.ns;
  sl.head_den = reinterpret_cast<uint8_t*>(walk_vids + 2 * kMaxChunk * static_cast<size_t>(B));

  // set-up: the slice's heads at column 0 and value ids, the replicated
  // counts, and (block 0) every output slot at -1 / -inf
  const size_t slots = static_cast<size_t>(n_chunks) * chunk;
  const size_t out0 = g * slots;
  for (int b = tid; b < B; b += kThreads) kinds[b] = L.kinds[b];
  for (int i = tid; i < sl.len; i += kThreads) {
    const int n = sl.lo + i;
    sl.jn[i] = 0;
    sl.jcap[i] = static_cast<uint16_t>(column_cap(in, L.g, n));
    slice_head(L, sl, i, 0);
    for (int b = 0; b < B; ++b) {
      sl.vids[static_cast<size_t>(b) * sl.ns + i] =
          static_cast<VT>(L.vids[static_cast<size_t>(b) * N + n] + 1);
    }
  }
  for (size_t i = tid; i < bv; i += kThreads) L.t.c[i] = bl.counts0[g * bv + i];
  if (rank == 0) {
    for (size_t s = tid; s < slots; s += kThreads) {
      out_choices[out0 + s] = -1;
      out_scores[out0 + s] = -INFINITY;
    }
  }
  const int count = counts[L.g];
  __syncthreads();
  L.kinds = kinds;  // compute_tables reads the shared copy from now on

  // a walk entry: its word, unclamped score and node's value ids
  const auto add_to_walk = [&](int par, int r, unsigned long long w, float raw) {
    const int i = column_node(w) - sl.lo;
    s_walk[par][r] = w;
    s_raw[r] = raw;
    for (int b = 0; b < B; ++b) {
      walk_vids[(static_cast<size_t>(par) * kMaxChunk + r) * B + b] =
          sl.vids[static_cast<size_t>(b) * sl.ns + i];
    }
  };

  int n_placed = 0;
  for (int step = 0; step < n_chunks; ++step) {
    const int want = min(chunk, count - n_placed);
    if (want <= 0) break;
    const int par = step & 1;
    compute_tables(L);  // frozen for the whole chunk
    unsigned long long mine = 0ull;  // this thread's best head (0: none fits)
    for (int i = tid; i < sl.len; i += kThreads) {
      sel[i] = slice_score(L, sl, kinds, i);
      const unsigned long long w = pack_column(sel[i], sl.lo + i, 0);
      if (sel[i] > -INFINITY && w > mine) mine = w;
    }

    // 1. each warp's heads among the slice's top `want` (a lane's nodes
    // are tid, tid + kThreads, ...). The warps' best heads bound those
    // from below: `want` of them lie at or above the want-th largest, so
    // each warp takes its own heads down to that one
    unsigned long long floor_word = 1ull;  // every head's word is above 0
    if (want > 1) {
      if (tid == 0) s_floor = 1ull;  // fewer than `want` warps hold a head
      const unsigned long long best = warp_max(mine);
      if (lane == 0) heads[warp * kMaxChunk] = best;
      __syncthreads();
      if (warp == 0) {
        const unsigned long long x = heads[lane * kMaxChunk];
        int above = 0;
        for (int l = 0; l < kWarps; ++l) above += heads[l * kMaxChunk] > x ? 1 : 0;
        if (x != 0ull && above == want - 1) s_floor = x;
      }
      __syncthreads();
      floor_word = s_floor;
    }
    uint32_t taken_mask = 0u;
    int n_heads = 0;
    for (int r = 0; r < want; ++r) {
      const unsigned long long top = warp_max(mine);
      if (top < floor_word) break;
      n_heads = r + 1;
      if (lane == 0) heads[warp * kMaxChunk + r] = top;
      if (mine == top && r + 1 < want) {  // this thread's best of the rest
        taken_mask |= 1u << ((column_node(top) - sl.lo - tid) / kThreads);
        mine = 0ull;
        for (int q = 0, i = tid; i < sl.len; ++q, i += kThreads) {
          const unsigned long long w = pack_column(sel[i], sl.lo + i, 0);
          if (!(taken_mask >> q & 1u) && sel[i] > -INFINITY && w > mine) mine = w;
        }
      }
    }
    if (lane >= n_heads && lane < kMaxChunk) heads[warp * kMaxChunk + lane] = 0ull;
    __syncthreads();
    // 2. the slice's top `want` heads
    if (warp == 0) {
      const int nh = warp_merge(heads, kWarps, want, [&](int l, int p, int r) {
        s_top[r] = heads[l * kMaxChunk + p];
      });
      if (lane == 0) s_ntop = nh;
    }
    __syncthreads();
    const int nh = s_ntop;
    if (want == 1) {
      // a walk of one entry: the slice's best head
      if (tid == 0) {
        if (nh > 0) add_to_walk(par, 0, s_top[0], sel[column_node(s_top[0]) - sl.lo]);
        for (int r = nh; r < kMaxChunk; ++r) s_walk[par][r] = 0ull;
      }
    } else {
      // 3. candidate m's columns jn + k, k < want, scored at once, then
      // clamped by their running minimum (-inf from the first that does
      // not fit)
      const int m = tid / kMaxChunk;
      const int k = tid % kMaxChunk;
      const bool live = tid < kColumns && m < nh && k < want;
      const int ci = live ? column_node(s_top[m]) - sl.lo : 0;
      if (tid < kColumns) {
        col_raw[tid] = !live ? -INFINITY
                     : k == 0 ? sel[ci]
                     : column_score(L, sl, kinds, ci, sl.jn[ci] + k);
      }
      __syncthreads();
      if (tid < kColumns) {
        float clamped = col_raw[m * kMaxChunk];
        for (int q = 1; q <= k; ++q) clamped = fminf(clamped, col_raw[m * kMaxChunk + q]);
        col_words[tid] = live && clamped > -INFINITY ? pack_column(clamped, sl.lo + ci, k)
                                                      : 0ull;
      }
      __syncthreads();
      // 4. the walk: the candidates' column lists merged
      if (warp == 0) {
        const int len = warp_merge(col_words, nh, want, [&](int l, int p, int r) {
          add_to_walk(par, r, col_words[l * kMaxChunk + p], col_raw[l * kMaxChunk + p]);
        });
        if (lane >= len && lane < kMaxChunk) s_walk[par][lane] = 0ull;
      }
    }
    cluster.sync();

    // every block merges the cluster's walks into the same picks
    if (tid < kWalkWords) {
      s_all[tid] = cluster.map_shared_rank(s_walk[par], tid / kMaxChunk)[tid % kMaxChunk];
    }
    __syncthreads();
    bool take = false;
    int pos = 0;
    unsigned long long w = 0ull;
    if (tid < kWalkWords) {
      w = s_all[tid];
      if (w != 0ull) {
        // its place in its own walk, plus the other walks' entries above
        // it (a 0 word never counts)
        const int b = tid / kMaxChunk;
        pos = tid % kMaxChunk;
        for (int o = 0; o < kCluster; ++o) {
          if (o == b) continue;
          for (int q = 0; q < chunk; ++q) pos += s_all[o * kMaxChunk + q] > w ? 1 : 0;
        }
        take = pos < want;
        if (take) s_src[pos] = tid;
      }
      if (tid / kMaxChunk == rank) s_kept[tid % kMaxChunk] = take ? 1 : 0;
    }
    const int taken = __syncthreads_count(take);
    if (take && tid / kMaxChunk == rank) {  // the owner block writes its picks
      const size_t slot = out0 + static_cast<size_t>(step) * chunk + pos;
      out_choices[slot] = column_node(w);
      out_scores[slot] = s_raw[tid % kMaxChunk];
    }
    // the picks' values counted in every block, in merge order, by warps
    // 1 on, beside the head moves in warp 0: each pick's staged value ids
    // read from the block that walked it (the reads issued at once)
    for (int b = tid - 32; b >= 0 && b < B; b += kThreads - 32) {
      int vv[kMaxChunk];
#pragma unroll
      for (int p = 0; p < kMaxChunk; ++p) {
        vv[p] = -1;
        if (p < taken) {
          const int src = s_src[p];
          const VT* ids = cluster.map_shared_rank(walk_vids, src / kMaxChunk);
          vv[p] = static_cast<int>(
                      ids[(static_cast<size_t>(par) * kMaxChunk + src % kMaxChunk) * B + b]) -
                  1;
        }
      }
#pragma unroll
      for (int p = 0; p < kMaxChunk; ++p) {
        if (vv[p] >= 0) L.t.c[b * V + vv[p]] = __fadd_rn(L.t.c[b * V + vv[p]], 1.0f);
      }
    }
    // the walk's taken entries are its prefix, and a node's are its next
    // columns in order: the last taken entry of each node moves its head
    if (tid < kMaxChunk && s_kept[tid]) {
      const unsigned long long mine_w = s_walk[par][tid];
      const int node = column_node(mine_w);
      const int k = column_k(mine_w);
      bool last = true;
      for (int r = 0; r < kMaxChunk && s_kept[r]; ++r) {
        const unsigned long long o = s_walk[par][r];
        last &= !(column_node(o) == node && column_k(o) == k + 1);
      }
      if (last) {
        const int i = node - sl.lo;
        const int j = sl.jn[i] + k + 1;
        sl.jn[i] = static_cast<uint16_t>(j);
        slice_head(L, sl, i, j);
      }
    }
    __syncthreads();  // counts bumped this chunk feed the next tables
    if (taken == 0) break;
    n_placed += taken;
  }
  cluster.sync();  // no block leaves while another may read its shared memory
}

// Dynamic shared memory each kernel may take: the card's opt-in maximum
// less the kernel's static shared memory, granted once per process by a
// thread-safe static (the launchers run with the GIL released), and never
// inside a CUDA graph capture: the first launch is an ordinary one.
struct SmemGrant {
  int error;
  size_t chunked;
  size_t opv;
  size_t cluster8;   // opv_cluster_kernel<uint8_t>
  size_t cluster16;  // opv_cluster_kernel<uint16_t>
  size_t chunked8;   // chunked_cluster_kernel<uint8_t>
  size_t chunked16;  // chunked_cluster_kernel<uint16_t>
};

cudaError_t grant(const void* kernel, int optin, size_t* room) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*room));
}

const SmemGrant& smem_grant() {
  static const SmemGrant granted = [] {
    SmemGrant out{0, 0, 0, 0, 0, 0, 0};
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    const std::pair<const void*, size_t*> kernels[] = {
        {reinterpret_cast<const void*>(chunked_kernel), &out.chunked},
        {reinterpret_cast<const void*>(opv_kernel), &out.opv},
        {reinterpret_cast<const void*>(opv_cluster_kernel<uint8_t>), &out.cluster8},
        {reinterpret_cast<const void*>(opv_cluster_kernel<uint16_t>), &out.cluster16},
        {reinterpret_cast<const void*>(chunked_cluster_kernel<uint8_t>), &out.chunked8},
        {reinterpret_cast<const void*>(chunked_cluster_kernel<uint16_t>), &out.chunked16},
    };
    for (const auto& k : kernels) {
      if (e == cudaSuccess) e = grant(k.first, optin, k.second);
    }
    out.error = static_cast<int>(e);
    return out;
  }();
  return granted;
}

int smem_limit(const void* kernel, size_t* limit) {
  const SmemGrant& granted = smem_grant();
  *limit = kernel == reinterpret_cast<const void*>(opv_kernel) ? granted.opv
                                                               : granted.chunked;
  return granted.error;
}

// Whether a launch runs a lane as a cluster, decided by shape alone: the
// one-per-value kernel (`opv`) needs V + 1 within one thread a segment,
// the chunked one at most 32 slice nodes a thread (its per-thread mask),
// both the block's share (the replicated tables and its node slice) in
// shared memory and value ids + 1 within 16 bits. Sets the block's
// dynamic shared memory (0: the one-block form) and the bytes of a staged
// value id.
int plan_cluster(int opv, int n, int b, int v, size_t* smem, int* id_bytes) {
  const SmemGrant& granted = smem_grant();
  *smem = 0;
  *id_bytes = v + 1 <= 256 ? 1 : 2;
  if (granted.error != 0) return granted.error;
  if (v + 1 > (opv ? kMaxSegments : 65536)) return 0;
  if (!opv && cluster_slice(n) > 32 * kThreads) return 0;
  const bool narrow = *id_bytes == 1;
  const size_t bytes = opv ? cluster_bytes(n, b, v, *id_bytes)
                           : chunked_cluster_bytes(n, b, v, *id_bytes);
  const size_t room = opv ? (narrow ? granted.cluster8 : granted.cluster16)
                          : (narrow ? granted.chunked8 : granted.chunked16);
  if (bytes <= room) *smem = bytes;
  return 0;
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

// The chunked scan (chunk 1: the value scan) in the form its shape picks.
int launch_chunked(const Inputs& in, const Blocks& bl, const int32_t* counts, int chunk,
                   int n_chunks, int g, unsigned char* scratch, int32_t* out_choices,
                   float* out_scores, cudaStream_t stream) {
  size_t smem = 0;
  int id_bytes = 0;
  int e = plan_cluster(0, in.n, bl.b, bl.v, &smem, &id_bytes);
  if (e != 0) return e;
  if (smem > 0) {
    if (chunk < 1 || chunk > kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        id_bytes == 1
            ? launch_cluster(chunked_cluster_kernel<uint8_t>, g, kCluster, kThreads, smem,
                             stream, in, bl, counts, chunk, n_chunks, out_choices, out_scores)
            : launch_cluster(chunked_cluster_kernel<uint16_t>, g, kCluster, kThreads, smem,
                             stream, in, bl, counts, chunk, n_chunks, out_choices, out_scores));
  }
  int in_smem = 0;
  e = plan_launch(0, in.n, bl.b, bl.v, scratch, &smem, &in_smem);
  if (e != 0) return e;
  chunked_kernel<<<g, kThreads, smem, stream>>>(in, bl, counts, chunk, n_chunks, scratch,
                                                in_smem, out_choices, out_scores);
  return static_cast<int>(cudaGetLastError());
}


// -- the coupled scans under a node-axis mesh ---------------------------------
//
// Under a dp x mp mesh each groups row of cells (i, 0..S-1) runs its
// lanes' scan over S node slices, one per cell, step by step, with a
// cross-shard reduction every step (the reference lays the same inputs
// out over its mesh, and XLA partitions every step of its lax.scan):
//  1. coupled_shard_step, a launch a cell: a block a lane scores the
//     cell's slice under the replicated count state and writes the
//     cell's candidates -- the chunked scan's top `want` entries of the
//     slice's clamped plane (chunk 1: the value scan's and the
//     one-per-value scan's first pick), or the one-per-value scan's
//     per-segment maxima -- each with its node's value ids, which only
//     the cell that owns the node holds;
//  2. the candidates cross to the row's lead, where coupled_step_merge
//     picks the step's winners, counts their values into c and writes
//     them, with c, into the row's record;
//  3. the record crosses back to every cell, and coupled_shard_apply
//     moves on the columns of the winners in the cell's slice.
// The one-per-value scan makes steps 1-2 twice a step: the first pick,
// then the segments under the count state after it.
//
// The candidates are exactly what the one-device kernels would pick from
// those nodes: a cell scores a node with head_score / advance /
// compute_tables (the same code, the same -fmad=false build, the boost
// summed over blocks in the same order), so a node's bits do not depend
// on the cell. A chunk's top entries of the whole plane are the top of
// the union of each slice's own top (the slices are disjoint and a
// node's clamped sequence is non-increasing), ordered by (value desc,
// node asc, column asc); argmax ties go to the lowest global node, as
// jnp.argmax; -0 folds onto +0 (order_key).
//
// What bounds it: sequential depth, as the one-device kernels, plus a
// launch on every cell and two copies a step (four for one-per-value);
// on one card the copies are same-device copies. The step loop runs in
// host code (coupled_sharded_scan): per-cell streams ordered by events,
// no host sync inside.

constexpr int kShardChunked = 0;   // top entries of the clamped plane
constexpr int kShardSegments = 1;  // per-segment maxima (one-per-value)
constexpr int kMergeChunked = 0;   // the chunked scan's (and value scan's) picks
constexpr int kMergeFirst = 1;     // the one-per-value scan's first pick
constexpr int kMergeSegments = 2;  // the one-per-value scan's segment picks

// A row's record, per lane, int32 words: the step's winners (their
// count, then up to kMaxPicks global nodes), the first pick's segment,
// whether it was taken, the lane's placements so far, then c [B, V] as
// float bits.
constexpr int kRecWins = 1;
constexpr int kRecVFirst = kRecWins + kMaxPicks;
constexpr int kRecOk0 = kRecVFirst + 1;
constexpr int kRecPlaced = kRecOk0 + 1;
constexpr int kRecordHead = kRecPlaced + 1;
// A candidate, int32 words: order key of its value (0: no candidate),
// global node, column offset from the node's next column (segments: the
// segment's presence flag on a call's first step), unclamped score as
// float bits, then the node's B value ids.
constexpr int kEntryHead = 4;

__host__ __device__ int record_words(int b, int v) { return kRecordHead + b * v; }

__device__ void empty_entry(int32_t* e, int b) {
  e[0] = 0;
  e[1] = -1;
  e[2] = 0;
  e[3] = __float_as_int(-INFINITY);
  for (int i = 0; i < b; ++i) e[kEntryHead + i] = -1;
}

// (key desc, node asc, column asc): whether entry a goes before entry b
__device__ __forceinline__ bool entry_before(const int32_t* a, const int32_t* b) {
  const uint32_t ka = static_cast<uint32_t>(a[0]);
  const uint32_t kb = static_cast<uint32_t>(b[0]);
  if (ka != kb) return ka > kb;
  if (a[1] != b[1]) return a[1] < b[1];
  return a[2] < b[2];
}

__device__ void count_values(float* c, const int32_t* e, int b, int v) {
  for (int i = 0; i < b; ++i) {
    const int x = e[kEntryHead + i];
    if (x >= 0) c[i * v + x] = __fadd_rn(c[i * v + x], 1.0f);
  }
}

// One launch a cell, a block a lane. `in.n` is the cell's slice and every
// node input the cell's part of it; `jn` [G, n] the slice's next columns;
// `record` the row's record as the cell last received it; `col0` the
// slice's first global node. Writes the lane's K candidates to `cand`
// [G, K, kEntryHead + B] (K = chunk, or V + 1 segments). `scratch` holds
// a lane's region (region_bytes), rebuilt every step.
template <int Mode>
__global__ void __launch_bounds__(kThreads)
coupled_shard_step_kernel(Inputs in, Blocks bl, const int32_t* counts,
                          const int32_t* enforce_idx, const int32_t* jn,
                          const int32_t* record, int chunk, int col0, int first_step,
                          unsigned char* scratch, int32_t* cand) {
  __shared__ unsigned long long red[kWarps + 1];
  const int tid = threadIdx.x;
  const int N = in.n;
  const int B = bl.b;
  const int V = bl.v;
  const size_t g = blockIdx.x;
  Lane L;
  L.in = in;
  L.bl = bl;
  L.g = static_cast<int>(blockIdx.x);
  L.t = carve(scratch + g * region_bytes(N, B, V), N, B, V);
  L.vids = bl.value_ids + g * B * N;
  L.kinds = bl.kinds + g * B;
  L.any_spread = false;
  for (int b = 0; b < B; ++b) {
    L.any_spread |= L.kinds[b] == kTargetSpread || L.kinds[b] == kEvenSpread;
  }
  const int32_t* rec = record + g * record_words(B, V);
  const float* rec_c = reinterpret_cast<const float*>(rec + kRecordHead);
  const int32_t* jn_in = jn + g * N;
  for (int i = tid; i < B * V; i += kThreads) L.t.c[i] = rec_c[i];
  for (int n = tid; n < N; n += kThreads) {
    L.t.jn[n] = static_cast<uint16_t>(jn_in[n]);
    L.t.jcap[n] = static_cast<uint16_t>(column_cap(in, L.g, n));
    set_head(L, n, jn_in[n]);
  }
  const int W = kEntryHead + B;
  const int K = Mode == kShardChunked ? chunk : V + 1;
  int32_t* out = cand + g * K * W;
  for (int i = tid; i < K; i += kThreads) empty_entry(out + static_cast<size_t>(i) * W, B);
  if (Mode == kShardSegments) {
    for (int s = tid; s <= V; s += kThreads) L.t.seg_best[s] = 0ull;
    for (int v = tid; v < V; v += kThreads) L.t.present[v] = 0;
  }
  __syncthreads();
  compute_tables(L);

  if (Mode == kShardChunked) {
    // chunked_kernel's rounds without the counting: each round's best
    // clamped head is an entry, its node takes its next column
    const int want = min(chunk, max(0, counts[g] - rec[kRecPlaced]));
    unsigned long long mine = 0ull;
    for (int n = tid; n < N; n += kThreads) {
      const float s = head_score(L, n);
      L.t.sel[n] = s;
      const unsigned long long w = pack(s, static_cast<uint32_t>(n));
      mine = w > mine ? w : mine;
    }
    for (int r = 0; r < want; ++r) {
      const unsigned long long best = block_max(mine, red);
      if (!(packed_value(best) > -INFINITY)) break;
      const int n = static_cast<int>(packed_index(best));
      if (n % kThreads == tid) {
        int32_t* e = out + static_cast<size_t>(r) * W;
        e[0] = static_cast<int32_t>(static_cast<uint32_t>(best >> 32));
        e[1] = col0 + n;
        e[2] = static_cast<int>(L.t.jn[n]) - jn_in[n];
        e[3] = __float_as_int(head_score(L, n));
        for (int b = 0; b < B; ++b) e[kEntryHead + b] = L.vids[static_cast<size_t>(b) * N + n];
        advance(L, n);
        L.t.sel[n] = fminf(L.t.sel[n], head_score(L, n));
        if (r + 1 < want) {
          mine = 0ull;
          for (int m = tid; m < N; m += kThreads) {
            const unsigned long long w = pack(L.t.sel[m], static_cast<uint32_t>(m));
            mine = w > mine ? w : mine;
          }
        }
      }
    }
  } else {
    // opv_kernel's segment maxima over the slice, the first pick's
    // segment excluded, under the count state after the first pick
    const int eidx = enforce_idx[g];
    const int32_t* evids = L.vids + static_cast<size_t>(eidx) * N;
    const uint8_t* elig = in.eligible + g * N;
    const int v_first = rec[kRecVFirst];
    for (int n = tid; n < N; n += kThreads) {
      const int s = evids[n] >= 0 ? evids[n] : V;
      const float s1 = s == v_first ? -INFINITY : head_score(L, n);
      atomicMax(&L.t.seg_best[s], pack(s1, static_cast<uint32_t>(col0 + n)));
      if (first_step && elig[n] && evids[n] >= 0) L.t.present[evids[n]] = 1;
    }
    __syncthreads();
    for (int s = tid; s <= V; s += kThreads) {
      const unsigned long long w = L.t.seg_best[s];
      if (w == 0ull) continue;
      int32_t* e = out + static_cast<size_t>(s) * W;
      const int node = static_cast<int>(packed_index(w));
      e[0] = static_cast<int32_t>(static_cast<uint32_t>(w >> 32));
      e[1] = node;
      e[2] = first_step && s < V ? L.t.present[s] : 0;
      e[3] = __float_as_int(packed_value(w));
      for (int b = 0; b < B; ++b) {
        e[kEntryHead + b] = L.vids[static_cast<size_t>(b) * N + (node - col0)];
      }
    }
  }
}

// The row's candidate lists, `gathered` [S, G, K, W] on the row's lead.
__device__ __forceinline__ const int32_t* entry_at(const int32_t* gathered, int s, int lanes,
                                                   int g, int k_entries, int q, int w) {
  return gathered + ((static_cast<size_t>(s) * lanes + g) * k_entries + q) * w;
}

// Block-wide min and max of one pair per thread; every thread gets both.
__device__ void block_minmax(float* mn, float* mx, float* red_f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float a = *mn;
  float b = *mx;
  for (int o = 16; o > 0; o >>= 1) {
    a = fminf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    red_f[warp] = a;
    red_f[kWarps + warp] = b;
  }
  __syncthreads();
  a = INFINITY;
  b = -INFINITY;
  for (int w = 0; w < kWarps; ++w) {
    a = fminf(a, red_f[w]);
    b = fmaxf(b, red_f[kWarps + w]);
  }
  __syncthreads();
  *mn = a;
  *mx = b;
}

// On the row's lead, a block a lane: the step's winners from the S lists,
// written to `out_choices` / `out_scores` (the step's first slot, `slots`
// a lane), counted into the record's c, and listed in the record.
// `present` [G, V] keeps the one-per-value scan's enforce-block values
// held by an eligible node (the OR of the cells' flags on the first step);
// `seg_words` [G, 2 (V + 1)] is its segment scratch.
template <int Mode>
__global__ void __launch_bounds__(kThreads)
coupled_step_merge_kernel(const int32_t* gathered, int cells, int lanes, int k_entries, int B,
                          int V, int32_t* record, const int32_t* counts, const int32_t* kinds,
                          const int32_t* enforce_idx, int32_t* present, int chunk, int first_step,
                          unsigned long long* seg_words, int32_t* out_choices, float* out_scores,
                          int slots) {
  __shared__ unsigned long long red[kWarps + 1];
  __shared__ float red_f[2 * kWarps];
  __shared__ int s_src[kMaxChunk];
  const int tid = threadIdx.x;
  const int g = static_cast<int>(blockIdx.x);
  const int W = kEntryHead + B;
  int32_t* rec = record + static_cast<size_t>(g) * record_words(B, V);
  float* c = reinterpret_cast<float*>(rec + kRecordHead);
  const int count = counts[g];
  const int n_placed = rec[kRecPlaced];
  int32_t* ch = out_choices + static_cast<size_t>(g) * slots;
  float* sc = out_scores + static_cast<size_t>(g) * slots;
  const auto entry = [&](int s, int q) {
    return entry_at(gathered, s, lanes, g, k_entries, q, W);
  };

  if (Mode == kMergeChunked) {
    // each live entry's rank in (key desc, node asc, column asc) among
    // every list's entries: taken below the lane's remaining count
    const int want = max(0, min(chunk, count - n_placed));
    const int total = cells * k_entries;
    bool take = false;
    if (tid < total) {
      const int32_t* e = entry(tid / k_entries, tid % k_entries);
      if (static_cast<uint32_t>(e[0]) != 0u && key_value(static_cast<uint32_t>(e[0])) > -INFINITY) {
        int rank = 0;
        for (int o = 0; o < total; ++o) {
          rank += entry_before(entry(o / k_entries, o % k_entries), e) ? 1 : 0;
        }
        take = rank < want;
        if (take) s_src[rank] = tid;
      }
    }
    const int taken = __syncthreads_count(take);
    if (tid < chunk) {
      const int32_t* e = tid < taken ? entry(s_src[tid] / k_entries, s_src[tid] % k_entries)
                                     : nullptr;
      ch[tid] = e != nullptr ? e[1] : -1;
      sc[tid] = e != nullptr ? __int_as_float(e[3]) : -INFINITY;
    }
    if (tid == 0) {
      for (int r = 0; r < taken; ++r) {
        const int32_t* e = entry(s_src[r] / k_entries, s_src[r] % k_entries);
        count_values(c, e, B, V);
        rec[kRecWins + r] = e[1];
      }
      rec[0] = taken;
      rec[kRecPlaced] = n_placed + taken;
    }
    return;
  }

  if (Mode == kMergeFirst) {
    if (tid != 0) return;
    const int32_t* best = nullptr;
    for (int s = 0; s < cells; ++s) {
      const int32_t* e = entry(s, 0);
      if (static_cast<uint32_t>(e[0]) == 0u) continue;
      if (best == nullptr || entry_before(e, best)) best = e;
    }
    const bool ok0 = best != nullptr && key_value(static_cast<uint32_t>(best[0])) > -INFINITY &&
                     n_placed < count;
    ch[0] = ok0 ? best[1] : -1;
    sc[0] = ok0 ? key_value(static_cast<uint32_t>(best[0])) : -INFINITY;
    const int eidx = enforce_idx[g];
    const int ev = best != nullptr ? best[kEntryHead + eidx] : -1;
    if (ok0) count_values(c, best, B, V);
    rec[0] = ok0 ? 1 : 0;
    rec[kRecWins] = ok0 ? best[1] : -1;
    rec[kRecVFirst] = ev >= 0 ? ev : V;
    rec[kRecOk0] = ok0 ? 1 : 0;
    rec[kRecPlaced] = n_placed + (ok0 ? 1 : 0);
    return;
  }

  // kMergeSegments: the segments' maxima over the S lists, the rotation
  // guard on the enforced block's counts after the first pick, then the
  // top (k_seg - 1) allowed segments by (value desc, segment asc) in
  // rounds of block argmax, as opv_kernel
  const int k_seg = chunk;
  const bool ok0 = rec[kRecOk0] != 0;
  const int eidx = enforce_idx[g];
  const bool even_enforce = kinds[static_cast<size_t>(g) * B + eidx] == kEvenSpread;
  int32_t* pres = present + static_cast<size_t>(g) * V;
  unsigned long long* words = seg_words + static_cast<size_t>(g) * 2 * (V + 1);
  unsigned long long* src = words + V + 1;
  if (first_step) {
    for (int v = tid; v < V; v += kThreads) {
      int p = 0;
      for (int s = 0; s < cells; ++s) p |= entry(s, v)[2];
      pres[v] = p != 0 ? 1 : 0;
    }
    __syncthreads();
  }
  const float* ec = c + static_cast<size_t>(eidx) * V;
  float mn = INFINITY;
  float mx = -INFINITY;
  int empty = 0;
  for (int v = tid; v < V; v += kThreads) {
    if (ec[v] > 0.0f) {
      mn = fminf(mn, ec[v]);
      mx = fmaxf(mx, ec[v]);
    } else if (pres[v]) {
      empty = 1;
    }
  }
  block_minmax(&mn, &mx, red_f);
  const bool no_empty = __syncthreads_or(empty) == 0;
  for (int s = tid; s <= V; s += kThreads) {
    const int32_t* best = nullptr;
    int from = 0;
    for (int o = 0; o < cells; ++o) {
      const int32_t* e = entry(o, s);
      if (static_cast<uint32_t>(e[0]) == 0u) continue;
      if (best == nullptr || entry_before(e, best)) {
        best = e;
        from = o;
      }
    }
    bool ok = true;
    if (s < V && even_enforce) {
      const bool pos1 = ec[s] > 0.0f;
      ok = no_empty ? pos1 && ec[s] <= mn && mx > mn : !pos1 && pres[s] != 0;
    }
    const float val = ok && best != nullptr ? key_value(static_cast<uint32_t>(best[0])) : -INFINITY;
    words[s] = val > -INFINITY ? pack(val, static_cast<uint32_t>(s)) : 0ull;
    src[s] = static_cast<unsigned long long>(from);
  }
  __syncthreads();
  const int limit = ok0 ? max(0, min(k_seg - 1, count - n_placed)) : 0;
  int taken = 0;
  for (int r = 0; r < limit; ++r) {
    unsigned long long mine = 0ull;
    for (int s = tid; s <= V; s += kThreads) mine = words[s] > mine ? words[s] : mine;
    const unsigned long long top = block_max(mine, red);
    if (top == 0ull) break;
    const int s = static_cast<int>(packed_index(top));
    if (tid == 0) {
      const int32_t* e = entry(static_cast<int>(src[s]), s);
      ch[1 + r] = e[1];
      sc[1 + r] = packed_value(top);
      count_values(c, e, B, V);
      rec[kRecWins + 1 + r] = e[1];
      words[s] = 0ull;
    }
    __syncthreads();
    ++taken;
  }
  for (int r = taken + tid; r < k_seg - 1; r += kThreads) {
    ch[1 + r] = -1;
    sc[1 + r] = -INFINITY;
  }
  if (tid == 0) {
    rec[0] = (ok0 ? 1 : 0) + taken;
    rec[kRecPlaced] = n_placed + taken;
  }
}

// One launch a cell, a thread a lane: each winner in the cell's slice
// [col0, col0 + n) takes its next column (a node the chunked scan took
// twice, two).
__global__ void coupled_shard_apply_kernel(int32_t* jn, const int32_t* record, int lanes, int n,
                                           int rec_words, int col0) {
  const int g = static_cast<int>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= lanes) return;
  const int32_t* rec = record + static_cast<size_t>(g) * rec_words;
  for (int w = 0; w < rec[0]; ++w) {
    const int i = rec[kRecWins + w] - col0;
    if (i >= 0 && i < n) jn[static_cast<size_t>(g) * n + i] += 1;
  }
}

// The launch just made: its error, and one more in `launched` (when
// given) if it was accepted. The launchers return before launching when
// there is no lane, and count nothing then.
cudaError_t launched_ok(long long* launched) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && launched != nullptr) ++*launched;
  return e;
}

cudaError_t launch_shard_step(int segments, const Inputs& in, const Blocks& bl,
                              const int32_t* counts, const int32_t* enforce_idx,
                              const int32_t* jn, const int32_t* record, int chunk, int col0,
                              int first_step, unsigned char* scratch, int32_t* cand, int lanes,
                              cudaStream_t stream, long long* launched = nullptr) {
  if (lanes == 0) return cudaSuccess;
  if (segments) {
    coupled_shard_step_kernel<kShardSegments><<<lanes, kThreads, 0, stream>>>(
        in, bl, counts, enforce_idx, jn, record, chunk, col0, first_step, scratch, cand);
  } else {
    coupled_shard_step_kernel<kShardChunked><<<lanes, kThreads, 0, stream>>>(
        in, bl, counts, enforce_idx, jn, record, chunk, col0, first_step, scratch, cand);
  }
  return launched_ok(launched);
}

cudaError_t launch_merge(int mode, const int32_t* gathered, int cells, int lanes, int k_entries,
                         int b, int v, int32_t* record, const int32_t* counts,
                         const int32_t* kinds, const int32_t* enforce_idx, int32_t* present,
                         int chunk, int first_step, unsigned long long* seg_words,
                         int32_t* out_choices, float* out_scores, int slots,
                         cudaStream_t stream, long long* launched = nullptr) {
  if (lanes == 0) return cudaSuccess;
  if (mode == kMergeChunked && (chunk > kMaxChunk || cells * k_entries > kThreads)) {
    return cudaErrorInvalidValue;
  }
  if (mode == kMergeSegments && chunk > kMaxPicks) return cudaErrorInvalidValue;
#define NOMAD_MERGE_ARGS                                                                    \
  gathered, cells, lanes, k_entries, b, v, record, counts, kinds, enforce_idx, present, chunk, \
      first_step, seg_words, out_choices, out_scores, slots
  if (mode == kMergeChunked) {
    coupled_step_merge_kernel<kMergeChunked><<<lanes, kThreads, 0, stream>>>(NOMAD_MERGE_ARGS);
  } else if (mode == kMergeFirst) {
    coupled_step_merge_kernel<kMergeFirst><<<lanes, 32, 0, stream>>>(NOMAD_MERGE_ARGS);
  } else {
    coupled_step_merge_kernel<kMergeSegments><<<lanes, kThreads, 0, stream>>>(NOMAD_MERGE_ARGS);
  }
#undef NOMAD_MERGE_ARGS
  return launched_ok(launched);
}

cudaError_t launch_apply(int32_t* jn, const int32_t* record, int lanes, int n, int rec_words,
                         int col0, cudaStream_t stream, long long* launched = nullptr) {
  if (lanes == 0) return cudaSuccess;
  coupled_shard_apply_kernel<<<(lanes + 127) / 128, 128, 0, stream>>>(
      jn, record, lanes, n, rec_words, col0);
  return launched_ok(launched);
}

// The per-cell pointers the step loop takes, in this order.
enum CellPtr {
  kPtrCapacity, kPtrUsed0, kPtrAsks, kPtrEligible, kPtrJobCounts, kPtrDesiredTotals,
  kPtrPenalty, kPtrAffinity, kPtrHasAff, kPtrDistinct, kPtrSlotCaps, kPtrValueIds,
  kPtrDesired, kPtrCaps, kPtrWeights, kPtrKinds, kPtrJitter, kPtrCounts, kPtrEnforce,
  kPtrJn,        // i32 [G, n]: the slice's next columns, zero at the start
  kPtrScratch,   // G regions (region_bytes)
  kPtrCand,      // i32 [G, K, W]: the cell's candidates
  kPtrRecord,    // i32 [G, R]: the row's record as the cell received it
  kPtrGathered,  // the row's lead only: i32 [S, G, K, W]
  kPtrMaster,    // the row's lead only: i32 [G, R], c = counts0 and zeros at the start
  kPtrPresent,   // the row's lead only: i32 [G, V]
  kPtrSegWords,  // the row's lead only: u64 [G, 2 (V + 1)]
  kPtrChoices,   // the row's lead only: i32 [G, slots]
  kPtrScores,    // the row's lead only: f32 [G, slots]
  kPtrHomeStream,  // the stream the cell's tensors were made on
  kCellPtrs
};

// The entries of the step loop's launch counts.
enum Launched { kLaunchedStep, kLaunchedMerge, kLaunchedApply };

// The sharded scan of one call: `rows` groups rows of `mp` cells each
// (cell (i, j) is index i * mp + j), `lanes` lanes a row over `n` slice
// nodes a cell; `opv` the one-per-value scan (`chunk` is then k_seg),
// else the chunked scan (chunk 1: the value scan). Every cell's work runs
// on a stream of its own on its device, each after its home stream's work
// so far; every home stream waits for its cell's last step. Candidates
// and records cross between cells with cudaMemcpyPeerAsync. Launches
// per cell and step: one shard step (two for opv) and one apply; per row
// and step one merge (two for opv). `launched` [3] gains the shard steps,
// merges and applies this call launched, counted where each launches.
int coupled_sharded_scan(int opv, int rows, int mp, const int* devices, void* const* ptrs,
                         int lanes, int n, int j, int b, int v, int spread, int chunk,
                         int n_steps, long long* launched) {
  const int cells = rows * mp;
  const int W = kEntryHead + b;
  const int k_first = opv ? 1 : chunk;
  const size_t rec_bytes = static_cast<size_t>(lanes) * record_words(b, v) * 4;
  const size_t cand_bytes = static_cast<size_t>(lanes) * k_first * W * 4;
  const size_t seg_bytes = static_cast<size_t>(lanes) * (v + 1) * W * 4;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  std::vector<cudaStream_t> st(cells, nullptr);
  std::vector<cudaEvent_t> done(cells, nullptr);
  std::vector<cudaEvent_t> merged(rows, nullptr);
  const auto P = [&](int cell, int k) { return ptrs[static_cast<size_t>(cell) * kCellPtrs + k]; };
  const auto check = [&](cudaError_t e) {
    if (err == cudaSuccess && e != cudaSuccess) err = e;
    return err == cudaSuccess;
  };
  for (int c = 0; c < cells && err == cudaSuccess; ++c) {
    check(cudaSetDevice(devices[c])) &&
        check(cudaStreamCreateWithFlags(&st[c], cudaStreamNonBlocking)) &&
        check(cudaEventCreateWithFlags(&done[c], cudaEventDisableTiming)) &&
        check(cudaEventRecord(done[c], static_cast<cudaStream_t>(P(c, kPtrHomeStream)))) &&
        check(cudaStreamWaitEvent(st[c], done[c], 0));
  }
  for (int i = 0; i < rows && err == cudaSuccess; ++i) {
    check(cudaSetDevice(devices[i * mp])) &&
        check(cudaEventCreateWithFlags(&merged[i], cudaEventDisableTiming));
  }
  const auto cell_inputs = [&](int c) {
    Inputs in{static_cast<const float*>(P(c, kPtrCapacity)),
              static_cast<const float*>(P(c, kPtrUsed0)),
              static_cast<const float*>(P(c, kPtrAsks)),
              static_cast<const uint8_t*>(P(c, kPtrEligible)),
              static_cast<const int32_t*>(P(c, kPtrJobCounts)),
              static_cast<const float*>(P(c, kPtrDesiredTotals)),
              static_cast<const uint8_t*>(P(c, kPtrPenalty)),
              static_cast<const float*>(P(c, kPtrAffinity)),
              static_cast<const uint8_t*>(P(c, kPtrHasAff)),
              static_cast<const uint8_t*>(P(c, kPtrDistinct)),
              static_cast<const float*>(P(c, kPtrSlotCaps)),
              static_cast<const float*>(P(c, kPtrJitter)),
              spread, n, j};
    return in;
  };
  const auto cell_blocks = [&](int c) {
    Blocks bl{static_cast<const int32_t*>(P(c, kPtrValueIds)), nullptr,
              static_cast<const float*>(P(c, kPtrDesired)),
              static_cast<const float*>(P(c, kPtrCaps)),
              static_cast<const float*>(P(c, kPtrWeights)),
              static_cast<const int32_t*>(P(c, kPtrKinds)), b, v};
    return bl;
  };
  // the record from every row's lead to each of its cells (the lead's own
  // stream already follows its merge)
  const auto broadcast = [&]() {
    for (int c = 0; c < cells && err == cudaSuccess; ++c) {
      const int lead = c / mp * mp;
      check(cudaSetDevice(devices[c])) &&
          (c == lead || check(cudaStreamWaitEvent(st[c], merged[c / mp], 0))) &&
          check(cudaMemcpyPeerAsync(P(c, kPtrRecord), devices[c], P(lead, kPtrMaster),
                                    devices[lead], rec_bytes, st[c]));
    }
  };
  // every cell's candidates, then each row's merge on its lead
  const auto exchange = [&](int segments, int k, int merge_mode, int first_step, int slot0) {
    const size_t bytes = segments ? seg_bytes : cand_bytes;
    for (int c = 0; c < cells && err == cudaSuccess; ++c) {
      const int lead = c / mp * mp;
      const int col0 = (c % mp) * n;
      char* slot = static_cast<char*>(P(lead, kPtrGathered)) + static_cast<size_t>(c % mp) * bytes;
      check(cudaSetDevice(devices[c])) &&
          check(launch_shard_step(segments, cell_inputs(c), cell_blocks(c),
                                  static_cast<const int32_t*>(P(c, kPtrCounts)),
                                  static_cast<const int32_t*>(P(c, kPtrEnforce)),
                                  static_cast<const int32_t*>(P(c, kPtrJn)),
                                  static_cast<const int32_t*>(P(c, kPtrRecord)), k, col0,
                                  first_step, static_cast<unsigned char*>(P(c, kPtrScratch)),
                                  static_cast<int32_t*>(P(c, kPtrCand)), lanes, st[c],
                                  launched + kLaunchedStep)) &&
          check(cudaMemcpyPeerAsync(slot, devices[lead], P(c, kPtrCand), devices[c], bytes,
                                    st[c])) &&
          check(cudaEventRecord(done[c], st[c]));
    }
    for (int i = 0; i < rows && err == cudaSuccess; ++i) {
      const int lead = i * mp;
      check(cudaSetDevice(devices[lead]));
      for (int c = lead + 1; c < lead + mp && err == cudaSuccess; ++c) {
        check(cudaStreamWaitEvent(st[lead], done[c], 0));
      }
      const int slots = n_steps * chunk;
      err == cudaSuccess &&
          check(launch_merge(merge_mode, static_cast<const int32_t*>(P(lead, kPtrGathered)), mp,
                             lanes, segments ? v + 1 : k, b, v,
                             static_cast<int32_t*>(P(lead, kPtrMaster)),
                             static_cast<const int32_t*>(P(lead, kPtrCounts)),
                             static_cast<const int32_t*>(P(lead, kPtrKinds)),
                             static_cast<const int32_t*>(P(lead, kPtrEnforce)),
                             static_cast<int32_t*>(P(lead, kPtrPresent)), chunk, first_step,
                             static_cast<unsigned long long*>(P(lead, kPtrSegWords)),
                             static_cast<int32_t*>(P(lead, kPtrChoices)) + slot0,
                             static_cast<float*>(P(lead, kPtrScores)) + slot0, slots,
                             st[lead], launched + kLaunchedMerge)) &&
          check(cudaEventRecord(merged[i], st[lead]));
    }
    broadcast();
  };
  // the master record as the rows' leads hold it at the start
  for (int i = 0; i < rows && err == cudaSuccess; ++i) {
    check(cudaSetDevice(devices[i * mp])) && check(cudaEventRecord(merged[i], st[i * mp]));
  }
  broadcast();
  for (int step = 0; step < n_steps && err == cudaSuccess; ++step) {
    if (opv) {
      exchange(0, 1, kMergeFirst, 0, step * chunk);
      exchange(1, v + 1, kMergeSegments, step == 0, step * chunk);
    } else {
      exchange(0, chunk, kMergeChunked, 0, step * chunk);
    }
    for (int c = 0; c < cells && err == cudaSuccess; ++c) {
      check(cudaSetDevice(devices[c])) &&
          check(launch_apply(static_cast<int32_t*>(P(c, kPtrJn)),
                             static_cast<const int32_t*>(P(c, kPtrRecord)), lanes, n,
                             record_words(b, v), (c % mp) * n, st[c],
                             launched + kLaunchedApply));
    }
  }
  // every home stream waits for its cell; then the streams and events go
  // (their resources are released once the device is done with them)
  for (int c = 0; c < cells; ++c) {
    if (st[c] == nullptr) continue;
    cudaSetDevice(devices[c]);
    if (done[c] != nullptr) {
      check(cudaEventRecord(done[c], st[c]));
      check(cudaStreamWaitEvent(static_cast<cudaStream_t>(P(c, kPtrHomeStream)), done[c], 0));
    }
  }
  for (int c = 0; c < cells; ++c) {
    cudaSetDevice(devices[c]);
    if (done[c] != nullptr) cudaEventDestroy(done[c]);
    if (st[c] != nullptr) cudaStreamDestroy(st[c]);
  }
  for (int i = 0; i < rows; ++i) {
    cudaSetDevice(devices[i * mp]);
    if (merged[i] != nullptr) cudaEventDestroy(merged[i]);
  }
  cudaSetDevice(prev);
  return err;
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
  int id_bytes = 0;
  const int e = plan_cluster(opv, n, b, v, &smem, &id_bytes);
  if (e != 0) return e;
  if (smem > 0) {
    *bytes = 0;
    return 0;
  }
  return plan_region(kernel_of(opv), n, b, v, &smem, bytes);
}

// Blocks a lane runs on at N nodes, B blocks and V values: the cluster
// size, or 1 for the one-block form (`opv`: the one-per-value kernel,
// else the chunked one and the value scan).
extern "C" int nomad_coupled_cluster(int opv, int n, int b, int v, int* blocks) {
  size_t smem = 0;
  int id_bytes = 0;
  const int e = plan_cluster(opv, n, b, v, &smem, &id_bytes);
  *blocks = smem > 0 ? kCluster : 1;
  return e;
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
  return launch_chunked(in, bl, counts, 1, max_steps, g, scratch, out_choices, out_scores,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int nomad_place_spread_chunked(
    NOMAD_COUPLED_PARAMS, int chunk, int n_chunks, unsigned char* scratch,
    int32_t* out_choices, float* out_scores, void* stream) {
  NOMAD_COUPLED_STRUCTS
  return launch_chunked(in, bl, counts, chunk, n_chunks, g, scratch, out_choices,
                        out_scores, static_cast<cudaStream_t>(stream));
}

extern "C" int nomad_place_spread_opv(
    NOMAD_COUPLED_PARAMS, const int32_t* enforce_idx, int k_seg, int n_chunks,
    unsigned char* scratch, int32_t* out_choices, float* out_scores,
    void* stream) {
  NOMAD_COUPLED_STRUCTS
  size_t smem = 0;
  int id_bytes = 0;
  int e = plan_cluster(1, n, b, v, &smem, &id_bytes);
  if (e != 0) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 0) {
    if (k_seg > kMaxPicks) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        id_bytes == 1
            ? launch_cluster(opv_cluster_kernel<uint8_t>, g, kCluster, kThreads, smem, st, in,
                             bl, enforce_idx, counts, k_seg, n_chunks, out_choices, out_scores)
            : launch_cluster(opv_cluster_kernel<uint16_t>, g, kCluster, kThreads, smem, st, in,
                             bl, enforce_idx, counts, k_seg, n_chunks, out_choices, out_scores));
  }
  int in_smem = 0;
  e = plan_launch(1, n, b, v, scratch, &smem, &in_smem);
  if (e != 0) return e;
  opv_kernel<<<g, kThreads, smem, st>>>(
      in, bl, enforce_idx, counts, k_seg, n_chunks, scratch, in_smem,
      out_choices, out_scores);
  return static_cast<int>(cudaGetLastError());
}

// -- the coupled scans under a node-axis mesh ---------------------------------

// Bytes of one lane's region (a shard step's per-step scratch).
extern "C" int nomad_coupled_region_bytes(int n, int b, int v, size_t* bytes) {
  *bytes = region_bytes(n, b, v);
  return 0;
}

// One shard step on one cell (`segments`: the one-per-value scan's
// segment maxima, else the top `chunk` entries); `g` lanes over the
// cell's `n` slice nodes, `col0` the slice's first global node.
extern "C" int nomad_coupled_shard_step(
    const float* capacity, const float* used0, const float* asks, const uint8_t* eligible,
    const int32_t* job_counts, const float* desired_totals, const uint8_t* penalty,
    const float* affinity, const uint8_t* has_aff, const uint8_t* distinct,
    const float* slot_caps, const int32_t* value_ids, const float* desired, const float* caps,
    const float* weights, const int32_t* kinds, const float* jitter, const int32_t* counts,
    const int32_t* enforce_idx, const int32_t* jn, const int32_t* record, int algorithm_spread,
    int g, int n, int j, int b, int v, int segments, int chunk, int col0, int first_step,
    unsigned char* scratch, int32_t* cand, void* stream) {
  Inputs in{capacity, used0,     asks,     eligible, job_counts,
            desired_totals, penalty, affinity, has_aff,  distinct,
            slot_caps, jitter, algorithm_spread, n, j};
  Blocks bl{value_ids, nullptr, desired, caps, weights, kinds, b, v};
  if (!segments && (chunk < 1 || chunk > kMaxChunk)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_shard_step(segments, in, bl, counts, enforce_idx, jn, record,
                                            chunk, col0, first_step, scratch, cand, g,
                                            static_cast<cudaStream_t>(stream)));
}

// One merge of `cells` candidate lists on a row's lead (`mode`: 0 the
// chunked scan, 1 the one-per-value first pick, 2 its segments).
extern "C" int nomad_coupled_step_merge(
    int mode, const int32_t* gathered, int cells, int lanes, int k_entries, int b, int v,
    int32_t* record, const int32_t* counts, const int32_t* kinds, const int32_t* enforce_idx,
    int32_t* present, int chunk, int first_step, unsigned long long* seg_words,
    int32_t* out_choices, float* out_scores, int slots, void* stream) {
  return static_cast<int>(launch_merge(mode, gathered, cells, lanes, k_entries, b, v, record,
                                       counts, kinds, enforce_idx, present, chunk, first_step,
                                       seg_words, out_choices, out_scores, slots,
                                       static_cast<cudaStream_t>(stream)));
}

// One apply on one cell.
extern "C" int nomad_coupled_shard_apply(int32_t* jn, const int32_t* record, int lanes, int n,
                                         int rec_words, int col0, void* stream) {
  return static_cast<int>(
      launch_apply(jn, record, lanes, n, rec_words, col0, static_cast<cudaStream_t>(stream)));
}

// The step loops: `ptrs` holds kCellPtrs pointers a cell (CellPtr order),
// `devices` each cell's device, `launched` i64[3] the launches made (shard
// steps, merges, applies), added to; see coupled_sharded_scan.
extern "C" int nomad_sharded_value_scan(int rows, int mp, const int* devices,
                                        void* const* ptrs, int lanes, int n, int j, int b,
                                        int v, int spread, int max_steps, long long* launched) {
  return static_cast<int>(coupled_sharded_scan(0, rows, mp, devices, ptrs, lanes, n, j, b, v,
                                               spread, 1, max_steps, launched));
}

extern "C" int nomad_sharded_spread_chunked(int rows, int mp, const int* devices,
                                            void* const* ptrs, int lanes, int n, int j, int b,
                                            int v, int spread, int chunk, int n_chunks,
                                            long long* launched) {
  if (chunk < 1 || chunk > kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(coupled_sharded_scan(0, rows, mp, devices, ptrs, lanes, n, j, b, v,
                                               spread, chunk, n_chunks, launched));
}

extern "C" int nomad_sharded_spread_opv(int rows, int mp, const int* devices,
                                        void* const* ptrs, int lanes, int n, int j, int b,
                                        int v, int spread, int k_seg, int n_chunks,
                                        long long* launched) {
  if (k_seg < 2 || k_seg > kMaxPicks) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(coupled_sharded_scan(1, rows, mp, devices, ptrs, lanes, n, j, b, v,
                                               spread, k_seg, n_chunks, launched));
}

// The per-cell pointer count the step loops read.
extern "C" int nomad_sharded_cell_ptrs() { return kCellPtrs; }
