// The launch-overhead probe's kernel: y = x + 1, one thread per element.
//
// Replaces, as an H100 probe, the Pallas call of
// dev/probe_launch_overhead.py::run (:50), a trivial x + 1 kernel over
// (8 * nb, 8, 128) float32 blocks (nb = 4 and 32) in a 50-step scan, which
// measures what one launch costs. Here a block of 1024 threads covers one
// (8, 128) tile; the grid covers the array (8 * nb * 8 tiles). The caller
// launches it 50 times back to back, eagerly and inside one CUDA graph.
//
// What bounds it: at these sizes (128 KB and 1 MB) the launch, not the 8
// bytes each element moves.
//
// The same source builds with g++ (no __CUDACC__): add_one_host() then
// loops over the elements on the CPU.

#pragma once

#include "common.cuh"

#define ADD_ONE_THREADS 1024

#ifdef __CUDACC__

__global__ void __launch_bounds__(ADD_ONE_THREADS)
    add_one_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

extern "C" int add_one_launch(const float* x, float* y, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + ADD_ONE_THREADS - 1) / ADD_ONE_THREADS;
  add_one_kernel<<<blocks, ADD_ONE_THREADS, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

#else

extern "C" int add_one_host(const float* x, float* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = x[i] + 1.0f;
  return 0;
}

#endif
