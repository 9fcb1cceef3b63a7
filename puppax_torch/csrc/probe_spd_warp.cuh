// The batched SPD solve A x = b for 18 x 18 systems, one warp per env:
// A (18, 18, B), b (18, B) in, x (18, B) out, every block row-major float32
// (env b of row r at ptr[r * B + b]), as csrc/probe_spd.cuh takes them.
//
// Replaces, as an H100 probe, the Pallas call of
// dev/pallas_spd_poc.py::pallas_spd_solve (:57, pallas_call :61), whose
// kernel (_spd_kernel, :29-54) runs a left-looking Cholesky of the symmetric
// A on (N, N, 256) tiles, then a forward and a back substitution. It is the
// Newton step's own solve (puppax/ops/linalg.py::spd_solve, 18 x 18 in the
// physics solver). csrc/probe_spd.cuh, one thread per env, stays beside it
// as the A/B.
//
// What bounds it: the bytes (A's 171-row triangle, b and x: 207 rows per env,
// 3.39 MB at 4096 envs) against ~2.8k float operations per env. One thread
// per env runs those operations as one dependent stream, 32 blocks of 128
// threads at 4096 envs, one warp per scheduler on 32 of the 132 SMs: nothing
// hides the latency of its 207 divisions and 18 square roots.
//
// The design: the algorithm is already vector-over-rows (for column k, every
// row i >= k takes the same operation, in j order), so lane i owns row i.
// - A block serves 32 envs, whose rows are one 128-byte segment each. Its
//   threads stage A's 171 rows on and below the diagonal (A[k][i], i >= k, at
//   SPDW_AT(k, i)) and b's 18 rows into shared memory with coalesced loads
//   (16 bytes a thread where B is a multiple of 4 and the bases are 16-byte
//   aligned), env-major with an odd stride of 189 floats, so a warp's reads
//   of one env's rows and the staging writes meet no bank conflict.
// - The block's W warps (a template argument: 4, 8, 16 or 32) each solve 32
//   / W of its envs in turn. Lanes 18-31 do no arithmetic.
// - Cholesky, column k: lane i >= k starts from A[k][i] and subtracts
//   L[j][k] * L[j][i] for j = 0..k-1 in order, L[j][k] from lane k by
//   __shfl_sync (lane i keeps its row of the factor in registers); the pivot
//   is sqrtf(pmax(acc_k, 1e-30f)) from lane k's sum, then each entry is a
//   true division by it. Lane i writes L[k][i] over A[k][i] in shared memory.
// - Forward substitution, column-oriented, interleaved with the factor: lane
//   k divides its sum by L[k][k] (y_k) in the same division instruction as
//   column k + 1's entries (lane k holds none of them), then every lane
//   i > k subtracts L[k][i] * y_k: per row the j-ascending order of
//   linalg.py's _solve_lower_cols. A division of its own per column would
//   put its latency on the factor's chain: the warp issues in order.
// - Back substitution, column-oriented, j descending: lane j divides its sum
//   by L[j][j] (x_j), and every lane k < j subtracts L[k][j] * x_j, lane k
//   reading column k of the factor back from shared memory: per row the
//   order of _solve_upper_t_cols.
// - x goes back through shared memory (over b's rows) and out as whole
//   128-byte segments; the ragged last block stores nothing past B.
// Every element keeps its operation order, pmax keeps jnp.maximum's NaN rule,
// division and sqrtf are correctly rounded and the build keeps --fmad=false,
// so the kernel equals its plain version (pallas_spd_poc.py::spd_solve_rows)
// and the one-thread kernel bit for bit.
//
// The same source builds with g++ (no __CUDACC__): probe_spd_warp_host() then
// stages each 32-env group into an array and emulates the warp: each step is
// a loop over the 32 lanes, a shuffle a read of the source lane's registers.

#pragma once

#include "common.cuh"

#define SPDW_N 18
#define SPDW_LANES 32
#define SPDW_ENVS 32  // envs per block: one 128-byte segment of every row
#define SPDW_TRI (SPDW_N * (SPDW_N + 1) / 2)  // A's rows on and below the diagonal
#define SPDW_ROWS (SPDW_TRI + SPDW_N)        // staged rows per env: A's triangle, then b
// A[k][i], i >= k (column k, row i of the factor), packed column by column
#define SPDW_AT(k, i) ((k) * SPDW_N - (k) * ((k) - 1) / 2 + (i) - (k))
#define SPDW_PARAMS \
  const float* __restrict__ A, const float* __restrict__ rhs, float* __restrict__ x

// one lane's registers: its row of the factor (L[j] = L[j][lane]), the
// column's sum, the substitutions' sum, L[lane][lane], and column `lane` of
// the factor for the back substitution (col[j] = L[lane][j], j > lane)
struct SpdwLane {
  float L[SPDW_N];
  float acc, y, diag;
  float col[SPDW_N];
};

#if defined(__CUDACC__)
#define SPDW_FN __device__
#define SPDW_UNROLL _Pragma("unroll")
// a step of the warp: this thread is lane `lane`; a shuffle reads lane src's
#define SPDW_EACH_LANE \
  {                    \
    const int lane = lane_id; SpdwLane& st = me;
#define SPDW_SHFL(field, src) __shfl_sync(0xffffffffu, st.field, (src))
#else
#define SPDW_FN
#define SPDW_UNROLL
// a step of the warp: a loop over the 32 lanes, each reading the registers
// that earlier steps left (no step writes a field it shuffles)
#define SPDW_EACH_LANE                          \
  for (int lane = 0; lane < SPDW_LANES; ++lane) { \
    SpdwLane& st = lanes[lane];
#define SPDW_SHFL(field, src) lanes[(src)].field
#endif
#define SPDW_END }

// the block row of A (or, past SPDW_TRI, of b) that staged row r holds
PUPPAX_HD static inline int spdw_block_row(int r) {
  if (r >= SPDW_TRI) return r - SPDW_TRI;
  int k = 0;
  while (r >= SPDW_N - k) {
    r -= SPDW_N - k;
    ++k;
  }
  return k * SPDW_N + k + r;
}

// Solve one env whose SPDW_ROWS staged rows start at a (env-major shared
// memory); x_i replaces b_i there.
SPDW_FN static inline void spdw_env(float* a, int lane_id) {
#if defined(__CUDACC__)
  SpdwLane me = {};
#else
  SpdwLane lanes[SPDW_LANES] = {};
  (void)lane_id;
#endif
  SPDW_EACH_LANE
    st.y = lane < SPDW_N ? a[SPDW_TRI + lane] : 0.0f;
  SPDW_END
  SPDW_UNROLL
  for (int k = 0; k < SPDW_N; ++k) {
    SPDW_EACH_LANE
      const bool on = lane >= k && lane < SPDW_N;
      if (on) st.acc = a[SPDW_AT(k, lane)];
      SPDW_UNROLL
      for (int j = 0; j < k; ++j) {
        const float ljk = SPDW_SHFL(L[j], k);
        if (on) st.acc = st.acc - ljk * st.L[j];
      }
    SPDW_END
    SPDW_EACH_LANE
      const float acc_k = SPDW_SHFL(acc, k);
      const bool on = lane >= k && lane < SPDW_N;
      // lane k - 1's y_{k-1} = y / L[k-1][k-1] shares column k's division
      if (on || (k > 0 && lane == k - 1)) {
        const float q = (on ? st.acc : st.y) / (on ? sqrtf(pmax(acc_k, 1e-30f)) : st.diag);
        if (on) {
          st.L[k] = q;
          a[SPDW_AT(k, lane)] = q;
        } else {
          st.y = q;
        }
      }
      if (lane == k) st.diag = st.L[k];
    SPDW_END
    if (k > 0) {
      SPDW_EACH_LANE
        const float y_prev = SPDW_SHFL(y, k - 1);
        if (lane >= k && lane < SPDW_N) st.y = st.y - st.L[k - 1] * y_prev;
      SPDW_END
    }
  }
  SPDW_EACH_LANE
    if (lane == SPDW_N - 1) st.y = st.y / st.diag;
  SPDW_END
#if defined(__CUDACC__)
  __syncwarp();  // the factor's columns, written by every lane, read by lane k
#endif
  SPDW_EACH_LANE
    SPDW_UNROLL
    for (int j = 0; j < SPDW_N; ++j)
      st.col[j] = (j > lane && lane < SPDW_N) ? a[SPDW_AT(lane, j)] : 0.0f;
  SPDW_END
  SPDW_UNROLL
  for (int j = SPDW_N - 1; j >= 0; --j) {
    SPDW_EACH_LANE
      if (lane == j) st.y = st.y / st.diag;
    SPDW_END
    SPDW_EACH_LANE
      const float xj = SPDW_SHFL(y, j);
      if (lane < j) st.y = st.y - st.col[j] * xj;
    SPDW_END
  }
  SPDW_EACH_LANE
    if (lane < SPDW_N) a[SPDW_TRI + lane] = st.y;
  SPDW_END
}

// the largest offset, (N * N - 1) * B + b, must fit an int
static inline int probe_spd_warp_args_ok(int B, int warps) {
  return B >= 0 && (long long)B * SPDW_N * SPDW_N <= 2147483647LL &&
         (warps == 4 || warps == 8 || warps == 16 || warps == 32);
}

#ifdef __CUDACC__

#include <stdint.h>

template <int W>
__global__ void __launch_bounds__(32 * W) probe_spd_warp_kernel(SPDW_PARAMS, int B, int vec) {
  __shared__ float sm[SPDW_ENVS * SPDW_ROWS];
  const int base = blockIdx.x * SPDW_ENVS;
  const int n = min(SPDW_ENVS, B - base);
  const int t = threadIdx.x;
  if (vec) {  // B % 4 == 0 and 16-byte bases: n is a multiple of 4
    for (int f = t; f < SPDW_ROWS * (SPDW_ENVS / 4); f += 32 * W) {
      const int r = f / (SPDW_ENVS / 4), e = 4 * (f % (SPDW_ENVS / 4));
      if (e < n) {
        const float* src = r < SPDW_TRI ? A : rhs;
        const float4 v =
            *reinterpret_cast<const float4*>(src + (size_t)spdw_block_row(r) * B + base + e);
        sm[(e + 0) * SPDW_ROWS + r] = v.x;
        sm[(e + 1) * SPDW_ROWS + r] = v.y;
        sm[(e + 2) * SPDW_ROWS + r] = v.z;
        sm[(e + 3) * SPDW_ROWS + r] = v.w;
      }
    }
  } else {
    for (int f = t; f < SPDW_ROWS * SPDW_ENVS; f += 32 * W) {
      const int r = f / SPDW_ENVS, e = f % SPDW_ENVS;
      if (e < n) {
        const float* src = r < SPDW_TRI ? A : rhs;
        sm[e * SPDW_ROWS + r] = src[(size_t)spdw_block_row(r) * B + base + e];
      }
    }
  }
  __syncthreads();
  for (int e = t >> 5; e < n; e += W) spdw_env(sm + e * SPDW_ROWS, t & 31);
  __syncthreads();
  if (vec) {
    for (int f = t; f < SPDW_N * (SPDW_ENVS / 4); f += 32 * W) {
      const int r = f / (SPDW_ENVS / 4), e = 4 * (f % (SPDW_ENVS / 4));
      if (e < n) {
        const float* s = sm + SPDW_TRI + r;
        *reinterpret_cast<float4*>(x + (size_t)r * B + base + e) =
            make_float4(s[(e + 0) * SPDW_ROWS], s[(e + 1) * SPDW_ROWS],
                        s[(e + 2) * SPDW_ROWS], s[(e + 3) * SPDW_ROWS]);
      }
    }
  } else {
    for (int f = t; f < SPDW_N * SPDW_ENVS; f += 32 * W) {
      const int r = f / SPDW_ENVS, e = f % SPDW_ENVS;
      if (e < n) x[(size_t)r * B + base + e] = sm[e * SPDW_ROWS + SPDW_TRI + r];
    }
  }
}

template <int W>
static int probe_spd_warp_go(SPDW_PARAMS, int B, int vec, cudaStream_t stream) {
  probe_spd_warp_kernel<W>
      <<<(B + SPDW_ENVS - 1) / SPDW_ENVS, 32 * W, 0, stream>>>(A, rhs, x, B, vec);
  return (int)cudaGetLastError();
}

extern "C" int probe_spd_warp_launch(SPDW_PARAMS, int B, int warps, void* stream) {
  if (!probe_spd_warp_args_ok(B, warps)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int vec = B % 4 == 0 && (((uintptr_t)A | (uintptr_t)rhs | (uintptr_t)x) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (warps) {
    case 4: return probe_spd_warp_go<4>(A, rhs, x, B, vec, s);
    case 8: return probe_spd_warp_go<8>(A, rhs, x, B, vec, s);
    case 16: return probe_spd_warp_go<16>(A, rhs, x, B, vec, s);
    default: return probe_spd_warp_go<32>(A, rhs, x, B, vec, s);
  }
}

#else

// W does not change the result: each env is one warp's, in any order
extern "C" int probe_spd_warp_host(SPDW_PARAMS, int B, int warps) {
  if (!probe_spd_warp_args_ok(B, warps)) return 1;
  float sm[SPDW_ENVS * SPDW_ROWS];
  for (int base = 0; base < B; base += SPDW_ENVS) {
    const int n = B - base < SPDW_ENVS ? B - base : SPDW_ENVS;
    for (int r = 0; r < SPDW_ROWS; ++r) {
      const float* src = r < SPDW_TRI ? A : rhs;
      for (int e = 0; e < n; ++e)
        sm[e * SPDW_ROWS + r] = src[(size_t)spdw_block_row(r) * B + base + e];
    }
    for (int e = 0; e < n; ++e) spdw_env(sm + e * SPDW_ROWS, 0);
    for (int r = 0; r < SPDW_N; ++r)
      for (int e = 0; e < n; ++e) x[(size_t)r * B + base + e] = sm[e * SPDW_ROWS + SPDW_TRI + r];
  }
  return 0;
}

#endif
