// jax's threefry2x32 hash and the draws made from it, one thread per
// (key, counter) pair.
//
// Replaces no TPU kernel: the JAX package draws with jax.random, which XLA
// lowers to its own threefry code (jax/_src/prng.py), and no pallas_call.
// The port draws the same numbers from the same keys (puppax_torch/
// random.py) and runs the hash here on the card, because eagerly the plain
// version is ~150 elementwise launches per draw and one env step makes
// tens of draws.
//
// threefry_kernel: keys (R, 2) int32 (the two uint32 words of a jax key,
// row r at keys[r * key_stride], so a column of split keys is read in
// place), the counters (hi, lo) = (0, offset + i) for i < n of every key (the
// partitionable layout's iota_2x32_shape), a thread per pair in a flat
// grid-stride loop, the key read per pair (the same 8 bytes for the n
// threads of a row, from L1). Each pair runs the 20 rounds and 5 key
// injections of prng.py's _threefry2x32_lowering in registers, its
// rotations by __funnelshift_l, and writes by mode:
//   0 (PAIRS)   out (R, n, 2) int32, both words (split, fold_in);
//   1 (BITS)    out (R, n) int32, bits1 ^ bits2 (random_bits);
//   2 (UNIFORM) out (R, n) float32, max(lo, fmaf(f, hi - lo, lo)) with f in
//               [0, 1) from the top 23 bits and the bounds lo[i], hi[i]
//               (random.py:_uniform, the multiply-add XLA contracts);
//   3 (NORMAL)  out (R, n) float32, sqrt(2) * erf_inv(u) with u uniform in
//               [nextafter(-1, 0), 1) and XLA's ErfInv32 (Giles), each
//               Horner step an fmaf.
//
// What bounds it: 8 bytes of key per row and 4 or 8 bytes out per pair,
// against ~100 integer operations per pair: at 4096 x 12 pairs the writes
// are 0.2-0.4 MB (~0.06-0.12 us at 3.35 TB/s), so a launch's fixed cost
// rules; the design keeps each draw to one launch.
//
// pow_check_kernel: out[i] = powf(x[i], y[i]), the text the emitter writes
// for a contact's solimp power other than 2 (kernels/cgen.py), held
// against torch's CUDA pow in chip_smoke.py.
//
// The same source builds with g++ (no __CUDACC__): threefry_host() and
// pow_check_host() loop over the pairs on the CPU.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define THREEFRY_THREADS 256

PUPPAX_HD static inline uint32_t threefry_rotl(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// one threefry2x32 hash: key (k0, k1), counter (x0, x1) -> (y0, y1)
PUPPAX_HD static inline void threefry2x32_pair(uint32_t k0, uint32_t k1, uint32_t x0,
                                               uint32_t x1, uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = threefry_rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// XLA's ErfInv32: Giles' polynomial, each Horner step one multiply-add
PUPPAX_HD static inline float threefry_erf_inv(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(-(x * x));
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, w, lt ? lt5[i] : ge5[i]);
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

PUPPAX_HD static inline float threefry_uniform(uint32_t bits, float lo, float hi) {
  union {
    uint32_t u;
    float f;
  } c;
  c.u = (bits >> 9) | 0x3F800000u;
  const float r = fmaf(c.f - 1.0f, hi - lo, lo);
  return r < lo ? lo : r;
}

// pair t of the flat (R, n) grid
PUPPAX_HD static inline void threefry_one(const int* keys, const float* lo, const float* hi,
                                          void* out, int n, int offset, int mode,
                                          long key_stride, long t) {
  const long row = t / n;
  const int i = (int)(t - row * n);
  uint32_t y0, y1;
  threefry2x32_pair((uint32_t)keys[key_stride * row], (uint32_t)keys[key_stride * row + 1], 0u,
                    (uint32_t)offset + (uint32_t)i, &y0, &y1);
  if (mode == 0) {
    ((int*)out)[2 * t] = (int)y0;
    ((int*)out)[2 * t + 1] = (int)y1;
  } else if (mode == 1) {
    ((int*)out)[t] = (int)(y0 ^ y1);
  } else if (mode == 2) {
    ((float*)out)[t] = threefry_uniform(y0 ^ y1, lo[i], hi[i]);
  } else {
    // nextafter(-1, 0) and sqrt(2) in float32
    const float u = threefry_uniform(y0 ^ y1, -0.99999994f, 1.0f);
    ((float*)out)[t] = 1.41421354f * threefry_erf_inv(u);
  }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREEFRY_THREADS)
    threefry_kernel(const int* __restrict__ keys, const float* __restrict__ lo,
                    const float* __restrict__ hi, void* __restrict__ out, long total, int n,
                    int offset, int mode, long key_stride) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride)
    threefry_one(keys, lo, hi, out, n, offset, mode, key_stride, t);
}

__global__ void __launch_bounds__(THREEFRY_THREADS)
    pow_check_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = powf(x[i], y[i]);
}

// keys, lo, hi (null unless mode 2), out; R keys key_stride ints apart, n
// counters each
extern "C" int threefry_launch(const void* keys, const void* lo, const void* hi, void* out,
                               int R, int n, int offset, int mode, int key_stride,
                               void* stream) {
  const long total = (long)R * n;
  if (total <= 0) return 0;
  long blocks = (total + THREEFRY_THREADS - 1) / THREEFRY_THREADS;
  if (blocks > 65535L * 32) blocks = 65535L * 32;
  threefry_kernel<<<(unsigned)blocks, THREEFRY_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const float*)lo, (const float*)hi, out, total, n, offset, mode,
      (long)key_stride);
  return (int)cudaGetLastError();
}

extern "C" int pow_check_launch(const void* x, const void* y, void* out, int n,
                                void* stream) {
  if (n <= 0) return 0;
  pow_check_kernel<<<(n + THREEFRY_THREADS - 1) / THREEFRY_THREADS, THREEFRY_THREADS, 0,
                     (cudaStream_t)stream>>>((const float*)x, (const float*)y, (float*)out, n);
  return (int)cudaGetLastError();
}

#else

extern "C" int threefry_host(const void* keys, const void* lo, const void* hi, void* out, int R,
                             int n, int offset, int mode, int key_stride) {
  const long total = (long)R * n;
  for (long t = 0; t < total; ++t)
    threefry_one((const int*)keys, (const float*)lo, (const float*)hi, out, n, offset, mode,
                 (long)key_stride, t);
  return 0;
}

extern "C" int pow_check_host(const void* x, const void* y, void* out, int n) {
  for (int i = 0; i < n; ++i) ((float*)out)[i] = powf(((const float*)x)[i], ((const float*)y)[i]);
  return 0;
}

#endif
