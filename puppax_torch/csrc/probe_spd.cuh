// The batched SPD solve A x = b for 18 x 18 systems, one thread per env,
// 128 threads per block: A (18, 18, B), b (18, B) in, x (18, B) out, every
// block row-major float32, so thread b's load of element (i, j) at
// A[(i * 18 + j) * B + b] coalesces across the warp.
//
// Replaces, as an H100 probe, the Pallas call of
// dev/pallas_spd_poc.py::pallas_spd_solve (:57, pallas_call :61), whose
// kernel (_spd_kernel, :29-54) runs a left-looking Cholesky of the symmetric
// A on (N, N, 256) tiles, then a forward and a back substitution. It is the
// Newton step's own solve (puppax/ops/linalg.py::spd_solve, at 18 x 18 in
// the physics solver).
//
// The design, for this card rather than block by block from the TPU's:
// - Column k of the factor is A's row k (A is symmetric) minus
//   sum_j L[j][k] * L[j], its pivot sqrt(max(acc_kk, 1e-30)), then
//   acc / pivot. Only the rows i >= k of each column are computed; the TPU
//   kernel's masked full-column arithmetic is dropped, and so are the loads
//   of A below its diagonal (171 of the 324 rows are read).
// - N is a compile-time 18 and every loop is fully unrolled, so the
//   factor's 171 nonzero entries (packed column by column, SPD_AT) have
//   compile-time indices and live in registers (ptxas -v says whether they
//   spill).
// - The subtraction order is puppax/ops/linalg.py's (:47-50, :66-88), the
//   pivot's max is jnp.maximum's (pmax: NaN propagates), the division a true
//   division, and the build keeps --fmad=false, so the kernel equals its
//   plain version (pallas_spd_poc.py::spd_solve_rows, the port's
//   ops/linalg.py::spd_solve) bit for bit: sqrt and division are correctly
//   rounded on both sides.
//
// What bounds it: the bytes (A's 171-row triangle, b and x: 207 rows per
// env, 3.39 MB at 4096 envs) against ~2.8k float operations per env; with one thread per env, each thread's
// dependent chain through 18 pivots and two substitutions.
//
// The same source builds with g++ (no __CUDACC__): probe_spd_host() then
// loops over the envs on the CPU.

#pragma once

#include "common.cuh"

#define SPD_N 18
#define SPD_THREADS 128
// column k, row i >= k of the factor, packed column by column
#define SPD_AT(k, i) ((k) * SPD_N - (k) * ((k) - 1) / 2 + (i) - (k))
#define SPD_PARAMS \
  const float* __restrict__ A, const float* __restrict__ rhs, float* __restrict__ x

#if defined(__CUDACC__)
#define SPD_UNROLL _Pragma("unroll")
#else
#define SPD_UNROLL
#endif

PUPPAX_HD static inline void probe_spd_env(SPD_PARAMS, int B, int b) {
  float L[SPD_N * (SPD_N + 1) / 2];
  SPD_UNROLL
  for (int k = 0; k < SPD_N; ++k) {
    float acc[SPD_N];
    SPD_UNROLL
    for (int i = k; i < SPD_N; ++i) acc[i] = A[(k * SPD_N + i) * B + b];
    SPD_UNROLL
    for (int j = 0; j < k; ++j) {
      const float ljk = L[SPD_AT(j, k)];
      SPD_UNROLL
      for (int i = k; i < SPD_N; ++i) acc[i] = acc[i] - ljk * L[SPD_AT(j, i)];
    }
    const float pivot = sqrtf(pmax(acc[k], 1e-30f));
    SPD_UNROLL
    for (int i = k; i < SPD_N; ++i) L[SPD_AT(k, i)] = acc[i] / pivot;
  }
  float y[SPD_N];
  SPD_UNROLL
  for (int k = 0; k < SPD_N; ++k) {
    float acc = rhs[k * B + b];
    SPD_UNROLL
    for (int j = 0; j < k; ++j) acc = acc - L[SPD_AT(j, k)] * y[j];
    y[k] = acc / L[SPD_AT(k, k)];
  }
  float xs[SPD_N];
  SPD_UNROLL
  for (int k = SPD_N - 1; k >= 0; --k) {
    float acc = y[k];
    SPD_UNROLL
    for (int j = SPD_N - 1; j > k; --j) acc = acc - L[SPD_AT(k, j)] * xs[j];
    xs[k] = acc / L[SPD_AT(k, k)];
    x[k * B + b] = xs[k];
  }
}

// the largest offset, (N * N - 1) * B + b, must fit an int
static inline int probe_spd_args_ok(int B) {
  return B >= 0 && (long long)B * SPD_N * SPD_N <= 2147483647LL;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(SPD_THREADS) probe_spd_kernel(SPD_PARAMS, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) probe_spd_env(A, rhs, x, B, b);
}

extern "C" int probe_spd_launch(SPD_PARAMS, int B, void* stream) {
  if (!probe_spd_args_ok(B)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + SPD_THREADS - 1) / SPD_THREADS;
  probe_spd_kernel<<<blocks, SPD_THREADS, 0, (cudaStream_t)stream>>>(A, rhs, x, B);
  return (int)cudaGetLastError();
}

#else

extern "C" int probe_spd_host(SPD_PARAMS, int B) {
  if (!probe_spd_args_ok(B)) return 1;
  for (int b = 0; b < B; ++b) probe_spd_env(A, rhs, x, B, b);
  return 0;
}

#endif
