// Launch shell of the unwrapped env-step kernel (K2).
//
// Replaces puppax/env/soa_env.py::_build_env_kernel (:533), the Pallas TPU
// kernel behind PupperV3Env.step on a batch of envs: kick, action latency,
// motor targets, the physics substeps (FK, COM, CRB, RNE, PD actuation,
// sparse LDL^T, uncapped narrowphase, one Newton step with an Illinois line
// search, semi-implicit Euler), observation, 18 rewards, termination and
// command resample, plus the last forward pass's caches (qacc, xpos, xquat,
// link velocities, site positions, actuator forces, contact distances and
// points) that the env's PhysicsState carries. The Episode and AutoReset
// wrappers stay outside the kernel, in PyTorch (env/wrappers.py).
//
// The per-env program is generated (puppax_torch/kernels/cgen.py) as
// env_step_body(); this file wraps it: one thread per env,
// __launch_bounds__(128), grid ceil(B / 128), a b < B guard and no padding.
// Every block is (rows, B) row-major float32, so thread b reads row r at
// ptr[r * B + b] and a warp's loads coalesce.
//
// What bounds it: per-thread registers and local-memory spills of a body of
// ~68k straight-line values (and the line search's stacked row arrays), not
// DRAM: the step moves a few KB per env. This first design does nothing
// about the spills on purpose. At the evaluator's 128 envs one launch is one
// block on one SM: the time is that of one thread's serial program.
//
// The same source builds with g++ (no __CUDACC__): env_step_host() then
// loops over the envs on the CPU.

#pragma once

#include "common.cuh"

#define ES_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ act, const float* __restrict__ env,           \
      const float* __restrict__ noi, const float* __restrict__ dr,            \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ cache_out, float* __restrict__ env_out
#define ES_ARGS q, v, act, env, noi, dr, q_out, v_out, cache_out, env_out

#include PUPPAX_KERNEL_BODY

#ifdef __CUDACC__

__global__ void __launch_bounds__(128) env_step_kernel(ES_PARAMS, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) env_step_body(ES_ARGS, B, b);
}

extern "C" int env_step_launch(ES_PARAMS, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  env_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(ES_ARGS, B);
  return (int)cudaGetLastError();
}

#else

extern "C" int env_step_host(ES_PARAMS, int B) {
  for (int b = 0; b < B; ++b) env_step_body(ES_ARGS, B, b);
  return 0;
}

#endif
