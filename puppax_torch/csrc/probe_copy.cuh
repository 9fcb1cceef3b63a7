// The overhead probes' copy kernel: one thread per env over (rows, B)
// row-major float32 blocks, 128 threads per block as the production shells,
// with three operand sets chosen by a runtime int (mode):
//
//   0, q:    q_out[r] = q[r] + 1e-7f for the nq rows of q;
//   1, min:  q and v in, q_out and v_out each + 1e-7f;
//   2, full: K1's operand set: q (nq rows), v (nv), ctrl (nu), dr (ndr) in;
//            q_out and v_out + 1e-7f, every cache row (ncache) = q[0], and
//            one sink row (sink_out) = the in-order sum of the env's ctrl
//            rows and then its dr rows.
//
// Replaces, as H100 probes, the Pallas copy kernels of
// dev/profile_overhead.py (call_copy :98, call_copy_min :120, call_copy_1
// :163 at grid = 1, copy_kernel :88-94, copy_min_kernel :112-116) and the
// 19-row copy of dev/profile_scan.py::kcall (:88, copy_kernel :77-79) and
// dev/probe_degradation.py::kcall (:93, :82-84). Operands the mode does not
// touch may be null.
//
// The sink row: the TPU's BlockSpec DMA moved the ctrl and dr blocks into
// VMEM though the kernel never read them, but a CUDA kernel moves only what
// it loads. Summing them into one stored row gives the full mode the TPU
// kernel's operand traffic: 604 rows per env (215 read, 389 written), as K1's
// probe shell (probe_physics.cuh), whose sink row keeps a cut's work live
// the same way.
//
// What bounds it: the bytes at 4096 envs (full: 9.9 MB, 2.95 us at 3.35
// TB/s), and at these sizes the launch more than the bytes; the probes time
// it eagerly and from a CUDA graph to tell the two apart.
//
// Every literal carries its f and the build keeps --fmad=false, so the
// kernel equals its plain version (probes/common.py::copy_rows) bit for bit.
// The same source builds with g++ (no __CUDACC__): probe_copy_host() then
// loops over the envs on the CPU.

#pragma once

#include "common.cuh"

#define PC_PARAMS                                                            \
  const float* __restrict__ q, const float* __restrict__ v,                   \
      const float* __restrict__ ctrl, const float* __restrict__ dr,           \
      float* __restrict__ q_out, float* __restrict__ v_out,                   \
      float* __restrict__ cache_out, float* __restrict__ sink_out
#define PC_ARGS q, v, ctrl, dr, q_out, v_out, cache_out, sink_out
#define PC_ROWS int nq, int nv, int nu, int ndr, int ncache
#define PC_THREADS 128
#define PC_EPS 1e-7f

PUPPAX_HD static inline void probe_copy_env(PC_PARAMS, int B, int mode, PC_ROWS, int b) {
  for (int r = 0; r < nq; ++r) q_out[r * B + b] = q[r * B + b] + PC_EPS;
  if (mode == 0) return;
  for (int r = 0; r < nv; ++r) v_out[r * B + b] = v[r * B + b] + PC_EPS;
  if (mode == 1) return;
  const float q0 = q[b];
  for (int r = 0; r < ncache; ++r) cache_out[r * B + b] = q0;
  float sink = 0.0f;
  for (int r = 0; r < nu; ++r) sink = sink + ctrl[r * B + b];
  for (int r = 0; r < ndr; ++r) sink = sink + dr[r * B + b];
  sink_out[b] = sink;
}

static inline int probe_copy_args_ok(int B, int mode) {
  return B >= 0 && mode >= 0 && mode <= 2;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(PC_THREADS)
    probe_copy_kernel(PC_PARAMS, int B, int mode, PC_ROWS) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) probe_copy_env(PC_ARGS, B, mode, nq, nv, nu, ndr, ncache, b);
}

extern "C" int probe_copy_launch(PC_PARAMS, int B, int mode, PC_ROWS, void* stream) {
  if (!probe_copy_args_ok(B, mode)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + PC_THREADS - 1) / PC_THREADS;
  probe_copy_kernel<<<blocks, PC_THREADS, 0, (cudaStream_t)stream>>>(
      PC_ARGS, B, mode, nq, nv, nu, ndr, ncache);
  return (int)cudaGetLastError();
}

#else

extern "C" int probe_copy_host(PC_PARAMS, int B, int mode, PC_ROWS) {
  if (!probe_copy_args_ok(B, mode)) return 1;
  for (int b = 0; b < B; ++b) probe_copy_env(PC_ARGS, B, mode, nq, nv, nu, ndr, ncache, b);
  return 0;
}

#endif
