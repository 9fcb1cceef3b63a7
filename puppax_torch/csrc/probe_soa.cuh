// Launch shell of the synthetic SoA substep: is a large straight-line
// per-env body viable on the card? One thread per env over (rows, B)
// row-major float32 blocks, 128 threads per block as the production shells:
// q (19 rows) and v (18 rows) in, q_out (19 rows) out.
//
// Replaces, as an H100 probe, the Pallas call of
// dev/pallas_soa_probe.py::soa_substep (:103, pallas_call :106), whose kernel
// (substep_like_kernel, :55-97) approximates one physics substep's op mix on
// (8, 128) tiles: a base quaternion normalized with rsqrt, 12 hinge chains of
// cos / sin, quaternion products and rotations, 60 rounds of an 18-term dot
// product each followed by 18 updates, a triangular chain of 18
// rsqrt(|a| + 1), and an integrate-like output. The body is
// soa_substep_body() from puppax_torch/probes/pallas_soa_probe.py
// (soa_substep_body(rounds)): one SSA statement per operation in the TPU
// kernel's order, as K1-K4 are emitted, so kernels/cgen.py::op_count counts
// it and a larger `rounds` gives a larger straight-line body.
//
// What bounds it: the operations (~7k float operations per env at 60 rounds
// against 56 rows of bytes), and in practice each thread's dependent chain
// through the rounds, whose every update reads the round's dot product.
//
// Every literal is the float32 rounding of the Python value with its f, rsqrt
// is 1.0f / sqrtf(x) and the build keeps --fmad=false, so the kernel equals
// its plain version (pallas_soa_probe.py::soa_substep_rows) bit for bit where
// cosf and sinf agree with torch's. The same source builds with g++ (no
// __CUDACC__): probe_soa_host() then loops over the envs on the CPU.

#pragma once

#include "common.cuh"

#define SOA_PARAMS \
  const float* __restrict__ q, const float* __restrict__ v, float* __restrict__ q_out
#define SOA_THREADS 128

#include PUPPAX_KERNEL_BODY

#ifdef __CUDACC__

__global__ void __launch_bounds__(SOA_THREADS) probe_soa_kernel(SOA_PARAMS, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) soa_substep_body(q, v, q_out, B, b);
}

extern "C" int probe_soa_launch(SOA_PARAMS, int B, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + SOA_THREADS - 1) / SOA_THREADS;
  probe_soa_kernel<<<blocks, SOA_THREADS, 0, (cudaStream_t)stream>>>(q, v, q_out, B);
  return (int)cudaGetLastError();
}

#else

extern "C" int probe_soa_host(SOA_PARAMS, int B) {
  if (B < 0) return 1;
  for (int b = 0; b < B; ++b) soa_substep_body(q, v, q_out, B, b);
  return 0;
}

#endif
