// Launch shell of the team physics-step probes: team K1's program, whole or
// cut after a phase, with the sink row, in two layouts.
//
// Replaces, as H100 probes in the production K1's design, the Pallas calls
// of dev/profile_kernel_phases.py::kcall (:68), which times K1 cut after
// each phase, and dev/profile_layout.py::kcall (:113), which times K1 in a
// row-major and a tile-major block layout. The body is
// physics_step_team_body() from puppax_torch/kernels/team.py
// (physics_step_team_body(s, n_substeps, warps, phase_limit, sink=True)):
// the cut program of probe_physics.cuh (the one-thread probes, kept as the
// A/B) split across the warps of a block by the production scheduler, as
// physics_step_team.cuh runs the whole program.
//
// Design, as physics_step_team.cuh: a block of TEAM_W warps serves 32 envs,
// one per lane, each warp running its own stream of every env's program;
// values that cross warps go through one dynamic shared array
// (TEAM_SHARED_FLOATS * 4 bytes, sized once with cudaFuncSetAttribute);
// __launch_bounds__(32 * TEAM_W, 1). Every thread reaches every barrier:
// lanes past B compute env B - 1 and store nothing, and the shell never
// returns early.
//
// Layouts (a runtime int), every block float32:
//   0, row-major:   (rows, B), as physics_step_team.cuh: env b at
//                   ptr[r * B + b];
//   1, block-major: (B / 32, rows, 32): one contiguous tile per block. The
//                   body indexes ptr[row * B + b], so the shell passes the
//                   tile's base pointers ptr + block * rows * 32, 32 as the
//                   body's B and the lane as b. B must be a multiple of 32
//                   (the launch returns cudaErrorInvalidValue otherwise).
// One __global__ kernel takes the layout as an argument, so the body keeps
// a single call site and one nvcc build serves both layouts.
//
// What bounds it: as team K1, the heaviest warp's stream and the barriers
// between its stages, not DRAM (the step moves ~2.4 KB per env). The probes
// ask which phase of team K1 costs what, and whether the layout moves it.
//
// The same source builds with g++ (no __CUDACC__): probe_physics_team_host()
// then runs TEAM_W std::threads per 32-env group (team_host_run), in either
// layout.

#pragma once

#include "team.cuh"

#define PP_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ ctrl, const float* __restrict__ dr,           \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ cache_out, float* __restrict__ sink_out
#define PP_ARGS q, v, ctrl, dr, q_out, v_out, cache_out, sink_out
#define PP_ROWS int nq, int nv, int nu, int ndr, int ncache

#include PUPPAX_KERNEL_BODY

// warp `warp`, lane `lane` of 32-env group g, in the given layout
TEAM_FN inline void probe_physics_team_group(PP_PARAMS, int B, int layout, PP_ROWS, int g,
                                             int warp, int lane, float* sh TEAM_BAR_PARAM) {
  const long t = layout == 1 ? (long)g * 32 : 0;
  physics_step_team_body(q + t * nq, v + t * nv, ctrl + t * nu, dr + t * ndr, q_out + t * nq,
                         v_out + t * nv, cache_out + t * ncache, sink_out + t,
                         layout == 1 ? 32 : B, layout == 1 ? lane : g * 32 + lane, warp, lane,
                         sh TEAM_BAR_ARG);
}

static inline int probe_physics_team_args_ok(int B, int layout) {
  return layout == 0 || (layout == 1 && B % 32 == 0);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(32 * TEAM_W, 1)
    probe_physics_team_kernel(PP_PARAMS, int B, int layout, PP_ROWS) {
  extern __shared__ float sh[];
  probe_physics_team_group(PP_ARGS, B, layout, nq, nv, nu, ndr, ncache, blockIdx.x,
                           threadIdx.x >> 5, threadIdx.x & 31, sh);
}

extern "C" int probe_physics_team_launch(PP_PARAMS, int B, int layout, PP_ROWS,
                                         void* stream) {
  if (!probe_physics_team_args_ok(B, layout)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int bytes = TEAM_SHARED_FLOATS * 4;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_physics_team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  probe_physics_team_kernel<<<(B + 31) / 32, 32 * TEAM_W, bytes, (cudaStream_t)stream>>>(
      PP_ARGS, B, layout, nq, nv, nu, ndr, ncache);
  return (int)cudaGetLastError();
}

#else

extern "C" int probe_physics_team_host(PP_PARAMS, int B, int layout, PP_ROWS) {
  if (!probe_physics_team_args_ok(B, layout)) return 1;
  return team_host_run(B, TEAM_W, TEAM_SHARED_FLOATS,
                       [&](int b, int warp, int lane, float* sh, std::barrier<>& bar) {
                         probe_physics_team_group(PP_ARGS, B, layout, nq, nv, nu, ndr, ncache,
                                                  b / 32, warp, lane, sh, bar);
                       });
}

#endif
