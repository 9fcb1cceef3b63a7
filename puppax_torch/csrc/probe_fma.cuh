// The multiply-add chain probe: does multiply-add contraction pay on the card?
//
// Replaces, as an H100 probe, the Pallas call of
// dev/probe_fma_fusion.py::run (:47), which compares K dependent
// y = y * a + b pairs against 2K dependent adds on one (8, 128) tile to see
// whether the TPU compiler fuses multiply-adds. Each element (g, i) of a
// grid of `blocks` x `n` elements runs one dependent chain (fma_chain below)
// of K multiply-add pairs (mode 0), 2K adds (mode 1) or 2K multiplies
// (mode 2) from the seed a[i] + g * 1e-9 (so every block's chain differs and
// nothing is hoisted, as dev/probe_fma_fusion.py:39-40 does) and writes
// out[g * n + i]. The library is built twice, under --fmad=false (a multiply
// and an add, each rounded: bit for bit with the plain torch loop) and under
// --fmad=true (ptxas may contract each pair into one FFMA). With contraction
// a mode-0 chain has half the dependent operations of a mode-1 chain.
//
// Two designs of the same function, each element's chain the same
// operations in the same order:
//
// 1. fma_chain_kernel, one element per thread (the first port, kept as the
//    A/B baseline): block g of the caller's grid, thread i. The TPU probe's
//    grid is 512 blocks x 1024 threads (throughput-bound); one 128-thread
//    block per SM is K1's occupancy (latency-bound).
//
// 2. fma_chain_ilp_kernel, the redesign for the H100's issue rate. What
//    bounds the chain is instruction issue: one warp instruction per clock
//    per SM sub-partition, 132 SMs x 128 FP32 lanes, so a contracted pair
//    (one FFMA) costs one issue slot, and operand reads: an FFMA whose three
//    sources are registers reads more of them than a clock's two register
//    banks give (a FADD or FMUL reads two), unless the operand reuse cache
//    serves one. The one-element kernel's SASS already unrolls its K loop
//    by 16 (16 FFMA beside an IADD3 / ISETP / BRA), yet its FFMA chain runs
//    at ~2 clocks per instruction while FADD and FMUL chains reach ~1.1.
//    The redesign gives each thread E = FMA_ILP_E (8) independent elements
//    that share one b: elements (g, i) of E consecutive blocks g at the
//    same i, so the E interleaved chains y_e = y_e * s_e + b[i] read one
//    register for b[i] (consecutive FFMAs in one operand slot: the reuse
//    cache's case) and E chains in flight hide the FFMA's latency; it
//    unrolls the K loop by 16, and sizes its grid to the blocks that fit on
//    the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//    striding over the ceil(blocks / E) x n groups: thread t of T takes
//    group t, then t + T, ..., so neighbouring threads touch neighbouring
//    addresses. A block past the last one (blocks not a multiple of E) is
//    computed from the last block's seed and not stored.
//
// The same source builds with g++ (no __CUDACC__, -ffp-contract=off):
// fma_chain_host() loops over the blocks and threads on the CPU, and
// fma_chain_ilp_host() runs the redesign's threads one after another on a
// grid of FMA_ILP_HOST_THREADS threads, so its strides and ragged edges are
// the card's code path.
//
// The per-SM grid (one 128-thread block per SM) is a latency measurement
// and runs the one-element kernel only.

#pragma once

#include "common.cuh"

#define FMA_ILP_THREADS 256
// elements per thread, chosen on the card among 1, 2, 4 and 8 (PERF.md)
#define FMA_ILP_E 8
#define FMA_ILP_HOST_THREADS 96
#ifdef __CUDACC__
#define FMA_ILP_UNROLL_K _Pragma("unroll 16")
#define FMA_ILP_UNROLL_E _Pragma("unroll")
#else
#define FMA_ILP_UNROLL_K
#define FMA_ILP_UNROLL_E
#endif

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

// the groups of the redesign: E consecutive blocks at one element i
static inline PUPPAX_HD long fma_chain_ilp_groups(int n, int blocks) {
  return (long)((blocks + FMA_ILP_E - 1) / FMA_ILP_E) * n;
}

// thread t of T in the redesign: per group (blocks gq * E .. gq * E + E - 1
// at element i), E interleaved chains that share b[i]
PUPPAX_HD static inline void fma_chain_ilp_thread(const float* a, const float* b, float* out,
                                                  int n, int blocks, long T, long t, int K,
                                                  int mode) {
  constexpr int E = FMA_ILP_E;
  const long groups = fma_chain_ilp_groups(n, blocks);
  for (long gi = t; gi < groups; gi += T) {
    const long gq = gi / n;
    const int i = (int)(gi - gq * n);
    const float c = b[i];
    float y[E], s[E];
    FMA_ILP_UNROLL_E
    for (int e = 0; e < E; ++e) {
      long g = gq * E + e;
      if (g >= blocks) g = blocks - 1;  // computed, not stored
      s[e] = a[i] + (float)g * 1e-9f;
      y[e] = s[e];
    }
    if (mode == 0) {
      FMA_ILP_UNROLL_K
      for (int k = 0; k < K; ++k) {
        FMA_ILP_UNROLL_E
        for (int e = 0; e < E; ++e) y[e] = y[e] * s[e] + c;
      }
    } else if (mode == 1) {
      FMA_ILP_UNROLL_K
      for (int k = 0; k < 2 * K; ++k) {
        FMA_ILP_UNROLL_E
        for (int e = 0; e < E; ++e) y[e] = y[e] + c;
      }
    } else {
      FMA_ILP_UNROLL_K
      for (int k = 0; k < 2 * K; ++k) {
        FMA_ILP_UNROLL_E
        for (int e = 0; e < E; ++e) y[e] = y[e] * s[e];
      }
    }
    FMA_ILP_UNROLL_E
    for (int e = 0; e < E; ++e)
      if (gq * E + e < blocks) out[(gq * E + e) * n + i] = y[e];
  }
}

static inline int fma_chain_args_ok(int n, int K, int mode, int blocks) {
  return n > 0 && blocks > 0 && mode >= 0 && mode <= 2 && K >= 0;
}

#ifdef __CUDACC__

__global__ void fma_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ out, int n, int K, int mode) {
  fma_chain_at(a, b, out, n, K, mode, blockIdx.x, threadIdx.x);
}

__global__ void __launch_bounds__(FMA_ILP_THREADS)
    fma_chain_ilp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         float* __restrict__ out, int n, int blocks, int K, int mode) {
  fma_chain_ilp_thread(a, b, out, n, blocks, (long)gridDim.x * blockDim.x,
                       (long)blockIdx.x * blockDim.x + threadIdx.x, K, mode);
}

// blocks of `threads` threads resident per SM at once: design 0 the
// one-element kernel, design 1 the redesign
extern "C" int fma_chain_occupancy(int design, int threads) {
  int per_sm = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (design == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fma_chain_kernel, threads, 0);
  else if (design == 1)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fma_chain_ilp_kernel, threads, 0);
  return e == cudaSuccess ? per_sm : -(int)e;
}

// the redesign's grid for blocks x n elements: enough FMA_ILP_THREADS-thread
// blocks for one pass over the groups (E elements per thread), at most the
// blocks resident on the card at once; a negative cudaError on failure
extern "C" int fma_chain_ilp_grid(int n, int blocks) {
  if (n <= 0 || blocks <= 0) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  static int resident = 0;  // read once
  if (resident == 0) {
    const int per_sm = fma_chain_occupancy(1, FMA_ILP_THREADS);
    if (per_sm <= 0) return per_sm < 0 ? per_sm : -(int)cudaErrorInvalidConfiguration;
    resident = per_sm;
  }
  const long groups = fma_chain_ilp_groups(n, blocks);
  const long need = (groups + FMA_ILP_THREADS - 1) / FMA_ILP_THREADS;
  const long most = (long)sms * resident;
  return (int)(need < most ? need : most);
}

extern "C" int fma_chain_launch(const float* a, const float* b, float* out, int n, int K,
                                int mode, int blocks, void* stream) {
  if (!fma_chain_args_ok(n, K, mode, blocks) || n > 1024) return (int)cudaErrorInvalidValue;
  fma_chain_kernel<<<blocks, n, 0, (cudaStream_t)stream>>>(a, b, out, n, K, mode);
  return (int)cudaGetLastError();
}

extern "C" int fma_chain_ilp_launch(const float* a, const float* b, float* out, int n, int K,
                                    int mode, int blocks, void* stream) {
  if (!fma_chain_args_ok(n, K, mode, blocks)) return (int)cudaErrorInvalidValue;
  const int grid = fma_chain_ilp_grid(n, blocks);
  if (grid <= 0) return grid < 0 ? -grid : (int)cudaErrorInvalidConfiguration;
  fma_chain_ilp_kernel<<<grid, FMA_ILP_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n, blocks,
                                                                          K, mode);
  return (int)cudaGetLastError();
}

#else

extern "C" int fma_chain_host(const float* a, const float* b, float* out, int n, int K,
                              int mode, int blocks) {
  if (!fma_chain_args_ok(n, K, mode, blocks)) return 1;
  for (int g = 0; g < blocks; ++g)
    for (int i = 0; i < n; ++i) fma_chain_at(a, b, out, n, K, mode, g, i);
  return 0;
}

extern "C" int fma_chain_ilp_host(const float* a, const float* b, float* out, int n, int K,
                                  int mode, int blocks) {
  if (!fma_chain_args_ok(n, K, mode, blocks)) return 1;
  const long T = FMA_ILP_HOST_THREADS;
  for (long t = 0; t < T; ++t) fma_chain_ilp_thread(a, b, out, n, blocks, T, t, K, mode);
  return 0;
}

#endif
