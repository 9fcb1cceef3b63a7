// The multiply-add chain probe: does multiply-add contraction pay on the card?
//
// Replaces, as an H100 probe, the Pallas call of
// dev/probe_fma_fusion.py::run (:47), which compares K dependent
// y = y * a + b pairs against 2K dependent adds on one (8, 128) tile to see
// whether the TPU compiler fuses multiply-adds. Here each thread runs one
// dependent chain (fma_chain below) of K multiply-add pairs (mode 0), 2K
// adds (mode 1) or 2K multiplies (mode 2); the library is built twice, under
// --fmad=false (a multiply and an add, each rounded: bit for bit with the
// plain torch loop) and under --fmad=true (ptxas may contract each pair
// into one FFMA). With contraction a mode-0 chain has half the dependent
// operations of a mode-1 chain.
//
// Layout: thread i of block g reads a[i] and b[i] (one tile of `n`
// elements, shared by every block, as the TPU grid revisits one tile) and
// writes out[g * n + i]. The seed a[i] + g * 1e-9 makes every block's chain
// differ, so nothing is hoisted (as dev/probe_fma_fusion.py:39-40 does).
// The grid is the caller's: 512 blocks x 1024 threads is the TPU probe's
// shape and throughput-bound; one 128-thread block per SM is K1's
// occupancy and latency-bound.
//
// The same source builds with g++ (no __CUDACC__, -ffp-contract=off):
// fma_chain_host() then loops over the blocks and threads on the CPU.

#pragma once

#include "common.cuh"

PUPPAX_HD static inline float fma_chain(float a, float b, int K, int mode) {
  float y = a;
  if (mode == 0) {
    for (int k = 0; k < K; ++k) y = y * a + b;
  } else if (mode == 1) {
    for (int k = 0; k < 2 * K; ++k) y = y + b;
  } else {
    for (int k = 0; k < 2 * K; ++k) y = y * a;
  }
  return y;
}

PUPPAX_HD static inline void fma_chain_at(const float* a, const float* b, float* out, int n,
                                          int K, int mode, int g, int i) {
  const float seeded = a[i] + (float)g * 1e-9f;
  out[(long)g * n + i] = fma_chain(seeded, b[i], K, mode);
}

#ifdef __CUDACC__

__global__ void fma_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ out, int n, int K, int mode) {
  fma_chain_at(a, b, out, n, K, mode, blockIdx.x, threadIdx.x);
}

extern "C" int fma_chain_launch(const float* a, const float* b, float* out, int n, int K,
                                int mode, int blocks, void* stream) {
  if (n <= 0 || n > 1024 || blocks <= 0 || mode < 0 || mode > 2 || K < 0)
    return (int)cudaErrorInvalidValue;
  fma_chain_kernel<<<blocks, n, 0, (cudaStream_t)stream>>>(a, b, out, n, K, mode);
  return (int)cudaGetLastError();
}

#else

extern "C" int fma_chain_host(const float* a, const float* b, float* out, int n, int K,
                              int mode, int blocks) {
  if (n <= 0 || blocks <= 0 || mode < 0 || mode > 2 || K < 0) return 1;
  for (int g = 0; g < blocks; ++g)
    for (int i = 0; i < n; ++i) fma_chain_at(a, b, out, n, K, mode, g, i);
  return 0;
}

#endif
