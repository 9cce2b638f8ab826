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
// through the usage and the per-group state, so the pass is one block on
// one SM and its time is steps x the latency of a step, far above both
// the bytes it must move and its operations.
//
// Design: one block of 1,024 threads loops over the steps.
//  - The node key of (g, n) does not depend on the state, and a commit
//    changes the usage of one node only, so only column `node` of the
//    feasibility changes in a step. The block keeps, per group, its best
//    feasible node (key desc, index asc); after a commit one warp looks at
//    column `node` for every active group: a group whose best it was and
//    which no longer fits there is queued, and a group that fits there
//    and prefers it takes it. A queued row's new best is the first
//    feasible node after the old one with the old key, if any (nodes
//    before it with that key were already infeasible, and infeasible
//    nodes stay so unless their column changes, which the column check
//    sees): the block looks for it in the next 1,024 nodes, one a thread,
//    and rescans the whole row only when that window has none. Keys tie
//    across a device class, so the window usually holds it. Rows are
//    handled 32 at a time (a warp reduction each, then one warp per row
//    over the warps' partials).
//  - A step is then: one warp picks the group (a warp argmin of the job
//    keys), commits and checks the column; one barrier; the rescans.
//  - The pass stops at the first step where nothing is placeable: that
//    step commits nothing, so every later step of the reference is the
//    same no-op.
//  - State (usage, placed, accum, best) lives in global memory (usage is
//    256 KB at 16,384 nodes); one block reads it back through its own L1.
//
// Numerics: IEEE division (__fdiv_rn), separately rounded adds and
// multiplies in the reference's order, and the build's -fmad=false. The
// kernel assumes finite keys (finite throughputs and costs), as every
// caller gives it.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-9f;
constexpr int kMaxmin = 0;
constexpr int kMakespan = 1;
constexpr int kCost = 2;

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
  int32_t* placed;         // [G] scratch
  float* accum;            // [G] scratch
  int32_t* best;           // [G] scratch: best feasible node, -1 = none
  int32_t* queue;          // [G] scratch: rows whose best stopped fitting
  int32_t* full;           // [G] scratch: rows to rescan whole
  int32_t* choices;        // [G, C]
  float* choice_tp;        // [G, C]
  float* used;             // [N, 4], holds used0 on entry
};

// argmax order: greater key, then lower row
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

__device__ __forceinline__ bool fits(const Hetero& h, int g, int n) {
  const float* u = h.used + 4 * static_cast<size_t>(n);
  const float* c = h.capacity + 4 * static_cast<size_t>(n);
  const float* a = h.asks + 4 * static_cast<size_t>(g);
  bool ok = true;
  for (int d = 0; d < 4; ++d) ok &= __fadd_rn(u[d], a[d]) <= c[d];
  const size_t gn = static_cast<size_t>(g) * h.n + n;
  return ok && h.eligible[gn] != 0 && h.tp[gn] > 0.0f;
}

__device__ __forceinline__ float node_key(const Hetero& h, int g, int n) {
  const float t = h.tp[static_cast<size_t>(g) * h.n + n];
  return h.policy == kCost ? __fdiv_rn(t, fmaxf(h.cost[n], kEps)) : t;
}

__device__ __forceinline__ float job_key(const Hetero& h, int g) {
  const float c = __int2float_rn(h.counts[g]);
  const float acc = h.accum[g];
  if (h.policy == kMaxmin) {
    return __fdiv_rn(acc, fmaxf(__fmul_rn(c, h.tpmax[g]), kEps));
  }
  if (h.policy == kMakespan) return -__fdiv_rn(c, fmaxf(acc, kEps));
  return -__fsub_rn(c, __int2float_rn(h.placed[g]));
}

// Best feasible node of each listed row; the whole block, 32 rows at a
// time. Ends in a barrier.
__device__ void rescan(const Hetero& h, const int32_t* rows, int nq,
                       float (*pk)[kWarps], int (*pr)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < nq; base += kWarps) {
    const int nb = min(kWarps, nq - base);
    for (int i = 0; i < nb; ++i) {
      const int g = rows[base + i];
      float bk = -INFINITY;
      int br = INT_MAX;
      for (int n = threadIdx.x; n < h.n; n += kThreads) {
        if (fits(h, g, n)) {
          const float k = node_key(h, g, n);
          if (before(k, n, bk, br)) {
            bk = k;
            br = n;
          }
        }
      }
      warp_argmax(bk, br);
      if (lane == 0) {
        pk[i][warp] = bk;
        pr[i][warp] = br;
      }
    }
    __syncthreads();
    if (warp < nb) {
      float bk = pk[warp][lane];
      int br = pr[warp][lane];
      warp_argmax(bk, br);
      if (lane == 0) h.best[rows[base + warp]] = br == INT_MAX ? -1 : br;
    }
    __syncthreads();
  }
}

// New best of each queued row (its old best still in `best`): the first
// feasible node with the old best's key in the kThreads nodes after it;
// rows without one go to the full rescan. Ends in a barrier.
__device__ void advance(const Hetero& h, int nq, int* nfull, int (*pr)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < nq; base += kWarps) {
    const int nb = min(kWarps, nq - base);
    for (int i = 0; i < nb; ++i) {
      const int g = h.queue[base + i];
      const int b = h.best[g];
      const int n = b + 1 + static_cast<int>(threadIdx.x);
      int r = INT_MAX;
      if (n < h.n && fits(h, g, n) && node_key(h, g, n) == node_key(h, g, b)) r = n;
      for (int off = 16; off > 0; off >>= 1) r = min(r, __shfl_xor_sync(kFull, r, off));
      if (lane == 0) pr[i][warp] = r;
    }
    __syncthreads();
    if (warp < nb) {
      int r = pr[warp][lane];
      for (int off = 16; off > 0; off >>= 1) r = min(r, __shfl_xor_sync(kFull, r, off));
      if (lane == 0) {
        const int g = h.queue[base + warp];
        if (r != INT_MAX) {
          h.best[g] = r;
        } else {
          h.full[atomicAdd(nfull, 1)] = g;
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) hetero_kernel(Hetero h) {
  __shared__ float pk[kWarps][kWarps];
  __shared__ int pr[kWarps][kWarps];
  __shared__ int s_any;
  __shared__ int s_nq;
  __shared__ int s_nfull;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int g = threadIdx.x; g < h.g; g += kThreads) {
    h.placed[g] = 0;
    h.accum[g] = 0.0f;
    h.full[g] = g;
  }
  __syncthreads();
  rescan(h, h.full, h.g, pk, pr);

  for (int step = 0; step < h.steps; ++step) {
    if (warp == 0) {
      // the group: least job key among placeable groups, first index
      float bk = INFINITY;
      int bj = INT_MAX;
      for (int g = lane; g < h.g; g += 32) {
        if (h.placed[g] < h.counts[g] && h.best[g] >= 0) {
          const float k = job_key(h, g);
          if (k < bk || (k == bk && g < bj)) {
            bk = k;
            bj = g;
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ok = __shfl_xor_sync(kFull, bk, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (ok < bk || (ok == bk && oj < bj)) {
          bk = ok;
          bj = oj;
        }
      }
      int nq = 0;
      if (bj != INT_MAX) {
        const int j = bj;
        const int node = h.best[j];
        if (lane == 0) {
          const int slot = h.placed[j];
          float* u = h.used + 4 * static_cast<size_t>(node);
          const float* a = h.asks + 4 * static_cast<size_t>(j);
          for (int d = 0; d < 4; ++d) u[d] = __fadd_rn(u[d], a[d]);
          const float t = h.tp[static_cast<size_t>(j) * h.n + node];
          h.choices[static_cast<size_t>(j) * h.max_c + slot] = node;
          h.choice_tp[static_cast<size_t>(j) * h.max_c + slot] = t;
          h.placed[j] = slot + 1;
          h.accum[j] = __fadd_rn(h.accum[j], t);
        }
        __syncwarp();
        // column `node` changed: queue the rows whose best no longer
        // fits there, move the rows that prefer it now
        for (int base = 0; base < h.g; base += 32) {
          const int g = base + lane;
          bool requeue = false;
          if (g < h.g && h.placed[g] < h.counts[g]) {
            const bool f = fits(h, g, node);
            const int b = h.best[g];
            if (b == node) {
              requeue = !f;
            } else if (f && (b < 0 || before(node_key(h, g, node), node,
                                             node_key(h, g, b), b))) {
              h.best[g] = node;
            }
          }
          const unsigned mask = __ballot_sync(kFull, requeue);
          if (requeue) h.queue[nq + __popc(mask & ((1u << lane) - 1u))] = g;
          nq += __popc(mask);
        }
      }
      if (lane == 0) {
        s_any = bj != INT_MAX;
        s_nq = nq;
        s_nfull = 0;
      }
    }
    __syncthreads();
    if (!s_any) break;
    if (s_nq > 0) {
      advance(h, s_nq, &s_nfull, pr);
      if (s_nfull > 0) rescan(h, h.full, s_nfull, pk, pr);
    }
  }
}

}  // namespace

// C entry point, bound with ctypes (nomad_tpu_torch/scheduler/hetero.py).
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// so a refused launch is reported to the caller. `used` holds used0 on
// entry (the pass updates it in place); `choices` and `choice_tp` hold -1
// and 0; `scratch` is 5 * g words.
extern "C" int nomad_hetero_place(
    const float* capacity, const float* asks, const int32_t* counts,
    const uint8_t* eligible, const float* tp, const float* tpmax,
    const float* cost, int policy, int g, int n, int steps, int max_c,
    int32_t* scratch, int32_t* choices, float* choice_tp, float* used,
    void* stream) {
  if (g < 1 || n < 1 || max_c < 1 || policy < kMaxmin || policy > kCost) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hetero h{capacity, asks, counts, eligible, tp, tpmax, cost, policy, g, n,
           steps, max_c, scratch, reinterpret_cast<float*>(scratch + g),
           scratch + 2 * g, scratch + 3 * g, scratch + 4 * g, choices,
           choice_tp, used};
  hetero_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(h);
  return static_cast<int>(cudaGetLastError());
}
