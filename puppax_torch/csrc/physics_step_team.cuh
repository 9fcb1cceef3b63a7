// Launch shell of the team physics-step kernel (team K1).
//
// Replaces puppax/physics/soa.py::_build_kernel (:2028), the Pallas TPU
// kernel behind soa.step_batched, as physics_step.cuh (the one-thread K1)
// does, and computes the same function bit for bit: the physics-only step
// of a batch of envs (n_substeps - 1 rounds of forward dynamics and
// semi-implicit Euler, one more forward pass whose caches it writes, a final
// integrate).
//
// Design for the H100: on the TPU every operation of the program is one
// vector operation over the envs in the lanes of an (8, 128) tile; the
// one-thread kernel runs one env's whole ~347k-operation program in one
// thread, so its time is one thread's dependent chain (with 168 registers
// and ~36 KB of spills). Here a block of TEAM_W warps serves 32 envs, one
// per lane, and each warp runs its own share of every env's program
// (puppax_torch/kernels/team.py): the program is split across the warps at
// barriers, values that cross warps go through shared memory, the line
// search's loops run in every warp with its row sums split across the
// warps. Grid ceil(B / 32), __launch_bounds__(32 * TEAM_W, 1), the shared
// memory dynamic (TEAM_SHARED_FLOATS * 4 bytes, above 48 KB after
// cudaFuncSetAttribute). Every thread reaches every barrier: lanes past B
// compute env B - 1 and store nothing.
//
// What bounds it: the heaviest warp's stream (about a third of the
// one-thread program on 4 warps, the replicated line-search work included:
// every warp runs the in-order row sums) and the barriers between its
// stages; not DRAM (the step moves 2.4 KB per env).
//
// Blocks are (rows, B) row-major float32 as in physics_step.cuh.

#pragma once

#include "team.cuh"

#define PS_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ ctrl, const float* __restrict__ dr,           \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ cache_out
#define PS_ARGS q, v, ctrl, dr, q_out, v_out, cache_out

#include PUPPAX_KERNEL_BODY

// A body whose indexed arrays live outside shared memory (a box model's:
// TEAM_SCRATCH_ROWS rows per env, csrc/team.cuh's SCR) reads and writes them
// in a scratch of TEAM_SCRATCH_ROWS * 32 floats per block: the caller
// allocates it and passes it with physics_step_team_set_scratch before
// launching (puppax_torch/kernels/build.py, bind_scratch); the host build
// allocates its own.
#ifdef TEAM_SCRATCH_ROWS
#define TEAM_SCR , scr
#else
#define TEAM_SCRATCH_ROWS 0
#define TEAM_SCR
#endif

extern "C" int physics_step_team_scratch_rows() { return TEAM_SCRATCH_ROWS; }

#ifdef __CUDACC__

__global__ void __launch_bounds__(32 * TEAM_W, 1)
    physics_step_team_kernel(PS_PARAMS, int B, float* scr) {
  (void)scr;
  extern __shared__ float sh[];
  const int lane = threadIdx.x & 31;
  physics_step_team_body(PS_ARGS, B, blockIdx.x * 32 + lane, threadIdx.x >> 5, lane,
                         sh TEAM_SCR);
}

static float* team_scratch = nullptr;

extern "C" int physics_step_team_set_scratch(void* scr) {
  team_scratch = (float*)scr;
  return 0;
}

extern "C" int physics_step_team_launch(PS_PARAMS, int B, void* stream) {
  if (B <= 0) return 0;
  if (TEAM_SCRATCH_ROWS && team_scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = TEAM_SHARED_FLOATS * 4;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        physics_step_team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  physics_step_team_kernel<<<(B + 31) / 32, 32 * TEAM_W, bytes, (cudaStream_t)stream>>>(
      PS_ARGS, B, team_scratch);
  return (int)cudaGetLastError();
}

#else

extern "C" int physics_step_team_host(PS_PARAMS, int B) {
  std::vector<float> scratch((size_t)TEAM_SCRATCH_ROWS * ((B + 31) / 32) * 32);
  float* scr = scratch.data();
  (void)scr;
  return team_host_run(B, TEAM_W, TEAM_SHARED_FLOATS,
                       [&](int b, int warp, int lane, float* sh, std::barrier<>& bar) {
                         physics_step_team_body(PS_ARGS, B, b, warp, lane, sh TEAM_SCR, bar);
                       });
}

#endif
