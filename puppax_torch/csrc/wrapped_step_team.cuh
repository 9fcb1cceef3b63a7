// Launch shell of the team wrapped env-step kernel (team K3).
//
// Replaces puppax/env/soa_env.py::_build_wrapped_kernel (:877), the Pallas
// TPU kernel behind the rollout fast lane's env step, as wrapped_step.cuh
// (the one-thread K3, kept as the A/B baseline) does, and computes the same
// function bit for bit: the AutoReset prologue, kick, action latency, motor
// targets, the physics substeps, observation, 18 rewards, termination,
// command resample and the episode step/truncation/restore.
//
// Design for the H100: as env_step_team.cuh. A block of TEAM_W warps serves
// 32 envs, one per lane, and each warp runs its own share of every env's
// program (puppax_torch/kernels/team.py, wrapped_step_team_body: the same
// rendering team K4 runs once per step). The one-thread K3 holds the whole
// ~67k-value body in one thread: 168 registers and ~36 KB of local-memory
// spills per thread, one dependent chain per env. Here each warp holds its
// stream's values only, values that cross warps go through shared memory
// (written early where the slots fit, which frees the owner's registers),
// and the heaviest stream is a fraction of the program. Grid ceil(B / 32),
// __launch_bounds__(32 * TEAM_W, 1), dynamic shared memory of
// TEAM_SHARED_FLOATS * 4 bytes (near the 227 KB a block may use: one block
// per SM). Lanes past B compute env B - 1 and store nothing, so every
// thread reaches every barrier; there is no early return.
//
// What bounds it: the heaviest warp's stream and the barriers between its
// stages, not DRAM. One step moves 515 input + 208 output float32 rows per
// env, ~11.8 MB at 4096 envs, ~3.5 us at 3.35 TB/s.
//
// Blocks are (rows, B) row-major float32 as in wrapped_step.cuh. Outputs
// must not alias inputs (the body's pointers are __restrict__).
//
// The same source builds with g++ (no __CUDACC__): wrapped_step_team_host()
// then runs TEAM_W std::threads, one per warp (csrc/team.cuh).

#pragma once

#include "team.cuh"

// WS_PARAMS / WS_ARGS, the body's parameters, are in common.cuh.

#include PUPPAX_KERNEL_BODY

// A body whose indexed arrays live outside shared memory (a box model's:
// TEAM_SCRATCH_ROWS rows per env, csrc/team.cuh's SCR) reads and writes them
// in a scratch of TEAM_SCRATCH_ROWS * 32 floats per block: the caller
// allocates it once and passes it with wrapped_step_team_set_scratch before
// launching (puppax_torch/kernels/build.py, bind_scratch); the host build
// allocates its own.
#ifdef TEAM_SCRATCH_ROWS
#define TEAM_SCR , scr
#else
#define TEAM_SCRATCH_ROWS 0
#define TEAM_SCR
#endif

extern "C" int wrapped_step_team_scratch_rows() { return TEAM_SCRATCH_ROWS; }

#ifdef __CUDACC__

__global__ void __launch_bounds__(32 * TEAM_W, 1)
    wrapped_step_team_kernel(WS_PARAMS, int B, float* scr) {
  (void)scr;
  extern __shared__ float sh[];
  const int lane = threadIdx.x & 31;
  wrapped_step_team_body(WS_ARGS, B, blockIdx.x * 32 + lane, threadIdx.x >> 5, lane, sh TEAM_SCR);
}

static float* team_scratch = nullptr;

extern "C" int wrapped_step_team_set_scratch(void* scr) {
  team_scratch = (float*)scr;
  return 0;
}

extern "C" int wrapped_step_team_launch(WS_PARAMS, int B, void* stream) {
  if (B <= 0) return 0;
  if (TEAM_SCRATCH_ROWS && team_scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = TEAM_SHARED_FLOATS * 4;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        wrapped_step_team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  wrapped_step_team_kernel<<<(B + 31) / 32, 32 * TEAM_W, bytes, (cudaStream_t)stream>>>(
      WS_ARGS, B, team_scratch);
  return (int)cudaGetLastError();
}

#else

extern "C" int wrapped_step_team_host(WS_PARAMS, int B) {
  std::vector<float> scratch((size_t)TEAM_SCRATCH_ROWS * ((B + 31) / 32) * 32);
  float* scr = scratch.data();
  (void)scr;
  return team_host_run(B, TEAM_W, TEAM_SHARED_FLOATS,
                       [&](int b, int warp, int lane, float* sh, std::barrier<>& bar) {
                         wrapped_step_team_body(WS_ARGS, B, b, warp, lane, sh TEAM_SCR, bar);
                       });
}

#endif
