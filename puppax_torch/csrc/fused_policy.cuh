// The policy side of the fused unroll (K4), shared by its one-thread shell
// (fused_unroll.cuh) and its team shell (fused_unroll_team.cuh): the
// kernel's parameters, the policy's shape as runtime ints, the hidden
// activations and the NormalTanh sample. Included after the generated
// body, whose #defines (K4_NU, K4_MIN_STD, ...) it reads.
//
// Every function is the plain version's operations in its order
// (env/fused_unroll.py: activate, softplus, policy_math), so that with
// --fmad=false both shells agree with it bit for bit.

#pragma once

#include "common.cuh"

#define K4_MAX_LAYERS 8   // env/fused_unroll.py MAX_LAYERS
#define K4_MAX_WIDTH 512  // env/fused_unroll.py MAX_WIDTH

#ifdef __CUDA_ARCH__
#define K4_LDG(p) __ldg(p)
#else
#define K4_LDG(p) (*(p))
#endif

// the policy's shape: n layers, the hidden activation's code (elu, relu,
// tanh, sigmoid, softmax: env/fused_unroll.py ACTIVATIONS) and the widths
struct K4Mlp {
  int n_layers;
  int act;
  int dims[K4_MAX_LAYERS + 1];
};

#define K4_PARAMS                                                               \
  const float* __restrict__ q0, const float* __restrict__ v0,                   \
      const float* __restrict__ env0, const float* __restrict__ wrap0,          \
      const float* __restrict__ phase0, const float* __restrict__ first,        \
      const float* __restrict__ dr, const float* __restrict__ noise,            \
      const float* __restrict__ eps, const float* __restrict__ weights,         \
      float *q_f, float *v_f, float *env_f, float *wrap_f,                      \
      float* __restrict__ phase_f, float* __restrict__ obs_ts,                  \
      float* __restrict__ act_ts, float* __restrict__ raw_ts,                   \
      float* __restrict__ logp_ts, float* __restrict__ aux_ts, float *q_s,      \
      float *v_s, float *env_s, float *wrap_s
#define K4_ARGS                                                                 \
  q0, v0, env0, wrap0, phase0, first, dr, noise, eps, weights, q_f, v_f, env_f, \
      wrap_f, phase_f, obs_ts, act_ts, raw_ts, logp_ts, aux_ts, q_s, v_s,       \
      env_s, wrap_s
#define K4_INTS                                                                 \
  int T, int n_layers, int act, int gait, int d0, int d1, int d2, int d3,       \
      int d4, int d5, int d6, int d7, int d8

static inline K4Mlp k4_mlp(K4_INTS) {
  K4Mlp m;
  m.n_layers = n_layers;
  m.act = act;
  const int d[K4_MAX_LAYERS + 1] = {d0, d1, d2, d3, d4, d5, d6, d7, d8};
  for (int i = 0; i <= K4_MAX_LAYERS; ++i) m.dims[i] = d[i];
  (void)T;
  (void)gait;
  return m;
}

// torch.nn.functional.softplus (threshold 20)
PUPPAX_HD static inline float k4_softplus(float x) {
  return x > K4_SOFTPLUS_THRESHOLD ? x : log1pf(expf(x));
}

// an elementwise hidden activation (elu, relu, tanh, sigmoid) on one unit
PUPPAX_HD static inline float k4_unit(int act, float x) {
  if (act == 0) return x > 0.0f ? x : expm1f(x);
  if (act == 1) return x > 0.0f ? x : 0.0f;
  if (act == 2) return tanhf(x);
  return 1.0f / (expf(-x) + 1.0f);
}

// the NormalTanh sample of one action from its loc, its scale parameter
// and the pre-drawn eps, and the action's term of the log-prob
struct K4Sample {
  float act, pre, term;
};

PUPPAX_HD static inline K4Sample k4_sample(float loc, float scale_param, float eps) {
  const float scale = k4_softplus(scale_param) + K4_MIN_STD;
  const float pre = loc + scale * eps;
  const float z = (pre - loc) / scale;
  const float normal_lp = ((-0.5f) * (z * z) - logf(scale)) - K4_HALF_LOG_2PI;
  const float fldj = 2.0f * ((K4_LOG2 - pre) - k4_softplus((-2.0f) * pre));
  return K4Sample{tanhf(pre), pre, normal_lp - fldj};
}

// the gait clock's tick, restarted on the effective done
PUPPAX_HD static inline float k4_tick(float phase, float done) {
  return done > 0.5f ? 0.0f : fmodf(phase + K4_DPHASE, K4_TWO_PI);
}
