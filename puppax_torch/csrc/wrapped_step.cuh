// Launch shell of the wrapped env-step kernel (K3).
//
// Replaces puppax/env/soa_env.py::_build_wrapped_kernel, the Pallas TPU
// kernel that runs one wrapped training env step per (8, 128) env tile:
// the AutoReset prologue, kick, action latency, motor targets, the physics
// substeps (FK, COM, CRB, RNE, PD actuation, sparse LDL^T, uncapped
// narrowphase, one Newton step with an Illinois line search, semi-implicit
// Euler), observation, 18 rewards, termination, command resample and the
// episode step/truncation/restore.
//
// The per-env program is generated (puppax_torch/kernels/cgen.py) as
// wrapped_step_body(); this file wraps it: one thread per env,
// __launch_bounds__(128), grid ceil(B / 128), a b < B guard and no padding.
// Every block is (rows, B) row-major float32, so thread b reads row r at
// ptr[r * B + b] and a warp's loads coalesce.
//
// What bounds it: per-thread registers and local-memory spills of a body of
// ~67k straight-line values (and the 140-row line-search arrays), not DRAM:
// the step moves ~2.9 KB per env (515 input rows + 208 output rows of
// float32), about 12 MB per 4096-env step. This first design does nothing
// about the spills on purpose; splitting the body or caching the substep
// state in shared memory is later work.
//
// The same source builds with g++ (no __CUDACC__): PUPPAX_HD is then empty
// and wrapped_step_host() loops over the envs on the CPU.

#pragma once

#include "common.cuh"

// WS_PARAMS / WS_ARGS, the body's parameters, are in common.cuh (K4 shares them).

#include PUPPAX_KERNEL_BODY

#ifdef __CUDACC__

__global__ void __launch_bounds__(128) wrapped_step_kernel(WS_PARAMS, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) wrapped_step_body(WS_ARGS, B, b);
}

extern "C" int wrapped_step_launch(WS_PARAMS, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  wrapped_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(WS_ARGS, B);
  return (int)cudaGetLastError();
}

#else

extern "C" int wrapped_step_host(WS_PARAMS, int B) {
  for (int b = 0; b < B; ++b) wrapped_step_body(WS_ARGS, B, b);
  return 0;
}

#endif
