// Per-candidate arithmetic shared by the placement kernels.
//
// A candidate is "the (j+1)-th instance of lane g's ask on node n". Its
// score is the reference _score_planes (nomad_tpu/device/score.py): a
// numerator summing the 10^x binpack or spread fit over cpu/mem, job
// anti-affinity, the reschedule penalty, node affinity and optional
// jitter, over a denominator counting the contributing components. The
// coupled kernels (coupled.cu) add a spread boost to both halves, so the
// halves are returned separately; closed_form.cu divides them at once.
//
// Numerics: IEEE division (__fdiv_rn), expf (not __expf), no fast math,
// and the build passes -fmad=false, so used0 + (j+1)*ask and the score
// sums round exactly as the separately-rounded reference ops do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLn10 = 2.302585092994046f;
constexpr float kMaxScore = 18.0f;  // BINPACK_MAX_SCORE

struct Inputs {
  const float* capacity;        // [N, 4]
  const float* used0;           // [N, 4]
  const float* asks;            // [G, 4]
  const uint8_t* eligible;      // [G, N]
  const int32_t* job_counts;    // [G, N]
  const float* desired_totals;  // [G]
  const uint8_t* penalty;       // [G, N]
  const float* affinity;        // [G, N]
  const uint8_t* has_aff;       // [G]
  const uint8_t* distinct;      // [G]
  const float* slot_caps;       // [G, N]
  const float* jitter;          // [N] or null
  int algorithm_spread;
  int n;
  int j;
};

// Total order on floats as u32: a larger float gives a larger key. -0
// folds onto +0, which compare equal as floats.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Feasible instance count of lane g on node n (reference _score_planes:
// min over asked dims of floor((cap - used0) / ask + 1e-6), masked by
// eligibility, capped by slot caps and distinct_hosts). Column j fits
// where j < the returned value.
__device__ float feasible_columns(const Inputs& in, int g, int n) {
  const float* cap = in.capacity + 4 * n;
  const float* used = in.used0 + 4 * n;
  const float* ask = in.asks + 4 * g;
  float jmax = INFINITY;
  for (int d = 0; d < 4; ++d) {
    if (ask[d] > 0.0f) {
      const float q = floorf(__fadd_rn(
          __fdiv_rn(__fsub_rn(cap[d], used[d]), fmaxf(ask[d], 1e-9f)), 1e-6f));
      jmax = fminf(jmax, q);
    }
  }
  const size_t gn = static_cast<size_t>(g) * in.n + n;
  if (!in.eligible[gn]) jmax = 0.0f;
  jmax = fminf(jmax, in.slot_caps[gn]);
  if (in.distinct[g]) jmax = in.job_counts[gn] == 0 ? fminf(jmax, 1.0f) : 0.0f;
  return jmax;
}

// Numerator and denominator of candidate (g, n, j), whether or not it
// fits: the reference planes hold both at every column.
__device__ void candidate_terms(const Inputs& in, int g, int n, int j,
                                float* num_out, float* den_out) {
  const float jf = static_cast<float>(j);
  const float* cap = in.capacity + 4 * n;
  const float* used = in.used0 + 4 * n;
  const float* ask = in.asks + 4 * g;
  const float mult = __fadd_rn(jf, 1.0f);
  float pow_sum = 0.0f;
  for (int d = 0; d < 2; ++d) {  // cpu, mem drive the fit score
    const float prop = __fadd_rn(used[d], __fmul_rn(mult, ask[d]));
    const float fr = cap[d] > 0.0f
        ? __fdiv_rn(__fsub_rn(cap[d], prop), fmaxf(cap[d], 1e-9f))
        : 1.0f;
    pow_sum = __fadd_rn(pow_sum, expf(__fmul_rn(kLn10, fr)));
  }
  const float fit_raw = in.algorithm_spread
      ? fminf(fmaxf(__fsub_rn(pow_sum, 2.0f), 0.0f), kMaxScore)
      : fminf(fmaxf(__fsub_rn(20.0f, pow_sum), 0.0f), kMaxScore);
  const float fit = __fdiv_rn(fit_raw, kMaxScore);
  const size_t gn = static_cast<size_t>(g) * in.n + n;
  const float coll = __fadd_rn(static_cast<float>(in.job_counts[gn]), jf);
  const bool has_coll = coll > 0.0f;
  const float anti = has_coll
      ? __fdiv_rn(-__fadd_rn(coll, 1.0f), fmaxf(in.desired_totals[g], 1.0f))
      : 0.0f;
  const bool pen = in.penalty[gn] != 0;
  const bool haff = in.has_aff[g] != 0;
  float num = __fadd_rn(fit, anti);
  num = __fadd_rn(num, pen ? -1.0f : 0.0f);
  num = __fadd_rn(num, haff ? in.affinity[gn] : 0.0f);
  if (in.jitter != nullptr) num = __fadd_rn(num, in.jitter[n]);
  *num_out = num;
  *den_out = 1.0f + (has_coll ? 1.0f : 0.0f) + (pen ? 1.0f : 0.0f) +
             (haff ? 1.0f : 0.0f);
}

// Unclamped score of candidate (g, n, j); -inf when it does not fit.
__device__ float raw_score(const Inputs& in, int g, int n, int j, float jmax) {
  if (!(static_cast<float>(j) < jmax)) return -INFINITY;
  float num, den;
  candidate_terms(in, g, n, j, &num, &den);
  return __fdiv_rn(num, den);
}

}  // namespace
