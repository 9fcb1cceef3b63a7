// Launch shell of the physics-step probes: K1's generated body, whole or cut
// after a phase, in two layouts and at 32, 64 or 128 threads per block.
//
// Replaces, as H100 probes, the Pallas calls of
// dev/profile_kernel_phases.py::kcall (:68), which times K1 cut after each
// phase, and dev/profile_layout.py::kcall (:113), which times K1 in a
// row-major and a tile-major block layout. The body is
// physics_step_body() from puppax_torch/kernels/cgen.py
// (physics_step_body(s, n_substeps, phase_limit, sink=True)); the production
// K1 keeps its own shell (physics_step.cuh) and build.
//
// A cut pads the outputs it has not reached with q[0], as the TPU emitter
// does, so every value that only those outputs would read is dead and
// nvcc drops it. The sink row (sink_out, one row) holds the sum of every
// value the cut pass computed, carried over the substeps, so each cut runs
// all the work up to its phase; the whole body stores 0 there.
//
// Layouts (a runtime int), every block float32:
//   0, row-major:   (rows, B), as physics_step.cuh: thread b reads row r at
//                   ptr[r * B + b];
//   1, block-major: (B / 128, rows, 128): env b lives in tile b / 128 at
//                   lane b % 128, so the body gets the tile's base pointers
//                   ptr + (b / 128) * rows * 128 and the row stride 128.
// The body takes its row stride as an argument, so it needs no change for
// either. One __global__ kernel takes the layout as an argument, so the
// 67k-line body keeps the single call site it has in physics_step.cuh and
// ptxas compiles it as it compiles K1: one nvcc build serves both layouts
// and every block size. Threads per block
// is a runtime int of 32, 64 or 128 under __launch_bounds__(128); B must be
// a multiple of 128 (the launch returns cudaErrorInvalidValue otherwise).
//
// What bounds it: as K1, each thread's dependent chain through a
// straight-line body with ~36 KB of spills, not DRAM. The probes ask which
// phase costs what, and whether the grid shape or the layout sets the time.
//
// The same source builds with g++ (no __CUDACC__): probe_physics_host()
// then loops over the envs on the CPU, in either layout.

#pragma once

#include "common.cuh"

#define PP_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ ctrl, const float* __restrict__ dr,           \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ cache_out, float* __restrict__ sink_out
#define PP_ARGS q, v, ctrl, dr, q_out, v_out, cache_out, sink_out
#define PP_ROWS int nq, int nv, int nu, int ndr, int ncache
#define PP_TILE 128

#include PUPPAX_KERNEL_BODY

// env b of a batch in the given layout
PUPPAX_HD static inline void probe_physics_env(PP_PARAMS, int B, int layout, PP_ROWS,
                                               int b) {
  const long tile = layout == 1 ? b / PP_TILE : 0;
  const int stride = layout == 1 ? PP_TILE : B;
  const int lane = layout == 1 ? b % PP_TILE : b;
  const long t = tile * PP_TILE;
  physics_step_body(q + t * nq, v + t * nv, ctrl + t * nu, dr + t * ndr, q_out + t * nq,
                    v_out + t * nv, cache_out + t * ncache, sink_out + t, stride, lane);
}

static inline int probe_physics_args_ok(int B, int threads, int layout) {
  return B % PP_TILE == 0 && (layout == 0 || layout == 1) &&
         (threads == 32 || threads == 64 || threads == 128);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
    probe_physics_kernel(PP_PARAMS, int B, int layout, PP_ROWS) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) probe_physics_env(PP_ARGS, B, layout, nq, nv, nu, ndr, ncache, b);
}

extern "C" int probe_physics_launch(PP_PARAMS, int B, int threads, int layout, PP_ROWS,
                                    void* stream) {
  if (!probe_physics_args_ok(B, threads, layout)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  probe_physics_kernel<<<B / threads, threads, 0, (cudaStream_t)stream>>>(
      PP_ARGS, B, layout, nq, nv, nu, ndr, ncache);
  return (int)cudaGetLastError();
}

#else

extern "C" int probe_physics_host(PP_PARAMS, int B, int threads, int layout, PP_ROWS) {
  if (!probe_physics_args_ok(B, threads, layout)) return 1;
  for (int b = 0; b < B; ++b)
    probe_physics_env(PP_ARGS, B, layout, nq, nv, nu, ndr, ncache, b);
  return 0;
}

#endif
