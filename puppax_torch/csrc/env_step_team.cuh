// Launch shell of the team unwrapped env-step kernel (team K2).
//
// Replaces puppax/env/soa_env.py::_build_env_kernel (:533), the Pallas TPU
// kernel behind PupperV3Env.step, as env_step.cuh (the one-thread K2) does,
// and computes the same function bit for bit: kick, action latency, motor
// targets, the physics substeps, observation, rewards, termination and
// command resample, plus the last forward pass's caches.
//
// Design for the H100: as physics_step_team.cuh. A block of TEAM_W warps
// serves 32 envs, one per lane, and each warp runs its own share of every
// env's program (puppax_torch/kernels/team.py). At the evaluator's 128 envs
// the one-thread kernel was one block on one SM, its time one thread's
// serial program; here it is 4 blocks of TEAM_W warps. Grid ceil(B / 32),
// __launch_bounds__(32 * TEAM_W, 1), dynamic shared memory of
// TEAM_SHARED_FLOATS * 4 bytes. Lanes past B compute env B - 1 and store
// nothing, so every thread reaches every barrier.
//
// What bounds it: the heaviest warp's stream and the barriers between its
// stages, not DRAM (the step moves a few KB per env).
//
// Blocks are (rows, B) row-major float32 as in env_step.cuh.

#pragma once

#include "team.cuh"

#define ES_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ act, const float* __restrict__ env,           \
      const float* __restrict__ noi, const float* __restrict__ dr,            \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ cache_out, float* __restrict__ env_out
#define ES_ARGS q, v, act, env, noi, dr, q_out, v_out, cache_out, env_out

#include PUPPAX_KERNEL_BODY

// A body whose indexed arrays live outside shared memory (a box model's:
// TEAM_SCRATCH_ROWS rows per env, csrc/team.cuh's SCR) reads and writes them
// in a scratch of TEAM_SCRATCH_ROWS * 32 floats per block: the caller
// allocates it once and passes it with env_step_team_set_scratch before
// launching (puppax_torch/kernels/build.py, bind_scratch); the host build
// allocates its own.
#ifdef TEAM_SCRATCH_ROWS
#define TEAM_SCR , scr
#else
#define TEAM_SCRATCH_ROWS 0
#define TEAM_SCR
#endif

extern "C" int env_step_team_scratch_rows() { return TEAM_SCRATCH_ROWS; }

#ifdef __CUDACC__

__global__ void __launch_bounds__(32 * TEAM_W, 1)
    env_step_team_kernel(ES_PARAMS, int B, float* scr) {
  (void)scr;
  extern __shared__ float sh[];
  const int lane = threadIdx.x & 31;
  env_step_team_body(ES_ARGS, B, blockIdx.x * 32 + lane, threadIdx.x >> 5, lane, sh TEAM_SCR);
}

static float* team_scratch = nullptr;

extern "C" int env_step_team_set_scratch(void* scr) {
  team_scratch = (float*)scr;
  return 0;
}

extern "C" int env_step_team_launch(ES_PARAMS, int B, void* stream) {
  if (B <= 0) return 0;
  if (TEAM_SCRATCH_ROWS && team_scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = TEAM_SHARED_FLOATS * 4;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        env_step_team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  env_step_team_kernel<<<(B + 31) / 32, 32 * TEAM_W, bytes, (cudaStream_t)stream>>>(
      ES_ARGS, B, team_scratch);
  return (int)cudaGetLastError();
}

#else

extern "C" int env_step_team_host(ES_PARAMS, int B) {
  std::vector<float> scratch((size_t)TEAM_SCRATCH_ROWS * ((B + 31) / 32) * 32);
  float* scr = scratch.data();
  (void)scr;
  return team_host_run(B, TEAM_W, TEAM_SHARED_FLOATS,
                       [&](int b, int warp, int lane, float* sh, std::barrier<>& bar) {
                         env_step_team_body(ES_ARGS, B, b, warp, lane, sh TEAM_SCR, bar);
                       });
}

#endif
