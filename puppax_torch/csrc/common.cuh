// Helpers shared by the launch shells of the generated kernels
// (wrapped_step.cuh, env_step.cuh, physics_step.cuh, fused_unroll.cuh) and
// by their generated bodies.
//
// The same source builds with g++ (no __CUDACC__): PUPPAX_HD is then empty
// and each shell's host entry loops over the envs on the CPU.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PUPPAX_HD __host__ __device__
#else
#define PUPPAX_HD
#endif

// jnp.maximum / jnp.minimum: NaN in either operand propagates
PUPPAX_HD static inline float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
PUPPAX_HD static inline float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// jnp.sign
PUPPAX_HD static inline float psign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// The parameters of the generated wrapped_step_body (K3's body, which the
// fused unroll K4 calls once per step), in block order.
#define WS_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ act, const float* __restrict__ env,           \
      const float* __restrict__ noi, const float* __restrict__ dr,            \
      const float* __restrict__ first, const float* __restrict__ wrap,        \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ env_out, float* __restrict__ wrap_out,              \
      float* __restrict__ aux_out
#define WS_ARGS \
  q, v, act, env, noi, dr, first, wrap, q_out, v_out, env_out, wrap_out, aux_out
