// Launch shell of the physics-step kernel (K1).
//
// Replaces puppax/physics/soa.py::_build_kernel (:2028), the Pallas TPU
// kernel behind soa.step_batched: the physics-only step of a batch of envs
// under constant controls. Each env runs n_substeps - 1 rounds of forward
// dynamics (FK, COM, CRB, RNE, PD actuation, tree-sparse LDL^T, the
// uncapped narrowphase over every candidate pair, one Newton step with an
// Illinois line search) plus semi-implicit Euler, then one more forward
// pass, whose caches (qacc, xpos, xquat, link velocities, site positions,
// actuator forces, contact distances and points) it writes, and a final
// integrate. Kick, actions, observation and rewards stay outside, in
// PyTorch (PupperV3Env._step_core, the physics-only lane).
//
// The per-env program is generated (puppax_torch/kernels/cgen.py) as
// physics_step_body(); this file wraps it: one thread per env,
// __launch_bounds__(128), grid ceil(B / 128), a b < B guard and no padding.
// Every block is (rows, B) row-major float32 (q 19, v 18, ctrl 12, dr 166
// in; q 19, v 18, caches 351 out for the flat Pupper), so thread b reads
// row r at ptr[r * B + b] and a warp's loads coalesce.
//
// What bounds it: per-thread registers and local-memory spills of a
// straight-line body of ~60k values, not DRAM (the step moves 2.4 KB per
// env). This first design does nothing about the spills on purpose.
//
// The same source builds with g++ (no __CUDACC__): physics_step_host() then
// loops over the envs on the CPU.

#pragma once

#include "common.cuh"

#define PS_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ ctrl, const float* __restrict__ dr,           \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ cache_out
#define PS_ARGS q, v, ctrl, dr, q_out, v_out, cache_out

#include PUPPAX_KERNEL_BODY

#ifdef __CUDACC__

__global__ void __launch_bounds__(128) physics_step_kernel(PS_PARAMS, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) physics_step_body(PS_ARGS, B, b);
}

extern "C" int physics_step_launch(PS_PARAMS, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  physics_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(PS_ARGS, B);
  return (int)cudaGetLastError();
}

#else

extern "C" int physics_step_host(PS_PARAMS, int B) {
  for (int b = 0; b < B; ++b) physics_step_body(PS_ARGS, B, b);
  return 0;
}

#endif
