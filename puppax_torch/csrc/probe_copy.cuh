// The overhead probes' copy kernel over (rows, B) row-major float32 blocks,
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
// Design (probe_copy_launch): element-parallel. Each flat block of the mode
// (q -> q_out, v -> v_out, q's row 0 -> the cache rows) is a segment of
// rows x B floats, and one thread takes 4 consecutive floats of it with a
// float4 load and store; a segment whose bases are not 16-byte aligned, or
// whose count (for the cache rows: B) is not a multiple of 4, takes one
// float a thread. The sink row takes a block of 128 threads per 8 envs:
// its 16 row groups load the envs' ctrl and dr rows into shared memory
// side by side, and after a barrier each env's own thread sums them in
// order, ctrl then dr, so an env's loads are in flight at once and only
// the in-order adds stay serial. The grid is sized to the threads
// (128 a block): mode q at 4096 envs is 19 x 4096 / 4 = 19,456 threads,
// 152 blocks, in a kernel of its one segment (probe_copy_q_kernel); modes
// min and full run all their segments, and the sink blocks, in one launch
// (probe_copy_kernel).
//
// The first design, one thread per env looping over the rows (at 4096 envs
// 32 blocks on 132 SMs, each thread ~600 dependent row accesses in full
// mode), stays as probe_copy_one_thread_launch: the probes' A/B baseline.
//
// What bounds it: the bytes at 4096 envs (full: 9.9 MB, 2.95 us at 3.35
// TB/s), and at these sizes the launch more than the bytes; the probes time
// it eagerly and from a CUDA graph to tell the two apart.
//
// Every literal carries its f and the build keeps --fmad=false, so both
// designs equal the plain version (probes/common.py::copy_rows) bit for
// bit. The same source builds with g++ (no __CUDACC__): probe_copy_host()
// then runs every thread of the segments in turn and each sink block's two
// phases one after the other, probe_copy_one_thread_host() every env.

#pragma once

#include <stdint.h>

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
#define PC_SINK_ENVS 8  // envs of one sink block; its threads split their rows

static inline int probe_copy_args_ok(int B, int mode) {
  return B >= 0 && mode >= 0 && mode <= 2;
}

// ---- the element-parallel design ----

// one segment: n floats of dst from src (+ 1e-7f), or, for the cache rows
// (bcast), dst[e] = src[e % B]; vec: 4 floats a thread
struct PcSeg {
  const float* src;
  float* dst;
  int n;
  int bcast;
  int vec;
};

// a launch's work: up to 3 segments, thread start[i] the first of segment
// i and start[3] the end; then, in full mode, sink_blocks blocks from
// block sink_block0, each the sink row of PC_SINK_ENVS envs
struct PcPlan {
  PcSeg seg[3];
  int start[4];
  int sink_block0, sink_blocks;
  const float* ctrl;
  const float* dr;
  float* sink;
  int nu, ndr, B;
};

#ifdef __CUDACC__
#define PC_UNROLL_8 _Pragma("unroll 8")
#else
#define PC_UNROLL_8
#endif

static inline int pc_aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the plan of one launch; false where a block has 2^31 floats or more
static inline bool probe_copy_plan(PC_PARAMS, int B, int mode, PC_ROWS, PcPlan* p) {
  const long Bl = B;
  const long rows[3] = {nq, mode >= 1 ? nv : 0, mode == 2 ? ncache : 0};
  const float* src[3] = {q, v, q};
  float* dst[3] = {q_out, v_out, cache_out};
  int at = 0;
  for (int i = 0; i < 3; ++i) {
    if (rows[i] * Bl >= (1L << 31) - 4) return false;
    PcSeg s = {src[i], dst[i], (int)(rows[i] * Bl), i == 2, 0};
    s.vec = pc_aligned(s.src) && pc_aligned(s.dst) && (s.bcast ? B % 4 == 0 : s.n % 4 == 0);
    p->seg[i] = s;
    p->start[i] = at;
    at += s.vec ? s.n / 4 : s.n;
  }
  p->start[3] = at;
  p->sink_block0 = (at + PC_THREADS - 1) / PC_THREADS;
  p->sink_blocks = mode == 2 ? (B + PC_SINK_ENVS - 1) / PC_SINK_ENVS : 0;
  p->ctrl = ctrl;
  p->dr = dr;
  p->sink = sink_out;
  p->nu = nu;
  p->ndr = ndr;
  p->B = B;
  return true;
}

PUPPAX_HD static inline void pc_copy4(const float* src, float* dst) {
#ifdef __CUDA_ARCH__
  const float4 x = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(dst) = make_float4(x.x + PC_EPS, x.y + PC_EPS, x.z + PC_EPS,
                                                x.w + PC_EPS);
#else
  for (int j = 0; j < 4; ++j) dst[j] = src[j] + PC_EPS;
#endif
}

PUPPAX_HD static inline void pc_bcast4(const float* src, float* dst) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#else
  for (int j = 0; j < 4; ++j) dst[j] = src[j];
#endif
}

// unit u of one segment
PUPPAX_HD static inline void pc_unit(const PcSeg& s, int u, int B) {
  if (s.vec) {
    const int e = 4 * u;
    if (s.bcast) pc_bcast4(s.src + e % B, s.dst + e);
    else pc_copy4(s.src + e, s.dst + e);
  } else {
    s.dst[u] = s.bcast ? s.src[u % B] : s.src[u] + PC_EPS;
  }
}

// thread i of the segments
PUPPAX_HD static inline void pc_segments(const PcPlan& p, int i) {
  if (i < p.start[1]) pc_unit(p.seg[0], i, p.B);
  else if (i < p.start[2]) pc_unit(p.seg[1], i - p.start[1], p.B);
  else if (i < p.start[3]) pc_unit(p.seg[2], i - p.start[2], p.B);
}

// sink block k (envs PC_SINK_ENVS k + e), thread t = PC_SINK_ENVS g + e:
// first thread t loads rows g, g + G, ... (G = the block's row groups) of
// env e's ctrl and dr rows into sm[row][PC_SINK_ENVS], all at once ...
PUPPAX_HD static inline void pc_sink_load(const PcPlan& p, int k, int t, float* sm) {
  const int e = t % PC_SINK_ENVS, b = PC_SINK_ENVS * k + e;
  if (b >= p.B) return;
  const int groups = PC_THREADS / PC_SINK_ENVS;
  PC_UNROLL_8
  for (int r = t / PC_SINK_ENVS; r < p.nu + p.ndr; r += groups)
    sm[r * PC_SINK_ENVS + e] = r < p.nu ? p.ctrl[r * p.B + b] : p.dr[(r - p.nu) * p.B + b];
}

// ... then env e's own thread (t = e) sums them in order, ctrl then dr
PUPPAX_HD static inline void pc_sink_sum(const PcPlan& p, int k, int t, const float* sm) {
  const int b = PC_SINK_ENVS * k + t;
  if (t >= PC_SINK_ENVS || b >= p.B) return;
  float sink = 0.0f;
  PC_UNROLL_8
  for (int r = 0; r < p.nu + p.ndr; ++r) sink = sink + sm[r * PC_SINK_ENVS + t];
  p.sink[b] = sink;
}

// ---- the one-thread design (the A/B baseline): one thread per env ----

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

#ifdef __CUDACC__

// mode q: one segment, nothing else
__global__ void __launch_bounds__(PC_THREADS)
    probe_copy_q_kernel(const __grid_constant__ PcSeg seg, int units, int B) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < units) pc_unit(seg, u, B);
}

// modes min and full: the segments, then the sink blocks (the plan stays
// in the parameter space: __grid_constant__, no local copy)
__global__ void __launch_bounds__(PC_THREADS)
    probe_copy_kernel(const __grid_constant__ PcPlan plan) {
  extern __shared__ float sm[];
  if ((int)blockIdx.x < plan.sink_block0) {
    pc_segments(plan, blockIdx.x * PC_THREADS + threadIdx.x);
    return;
  }
  const int k = blockIdx.x - plan.sink_block0;  // block-uniform: every thread syncs
  pc_sink_load(plan, k, threadIdx.x, sm);
  __syncthreads();
  pc_sink_sum(plan, k, threadIdx.x, sm);
}

extern "C" int probe_copy_launch(PC_PARAMS, int B, int mode, PC_ROWS, void* stream) {
  if (!probe_copy_args_ok(B, mode)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  PcPlan plan;
  if (!probe_copy_plan(PC_ARGS, B, mode, nq, nv, nu, ndr, ncache, &plan))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    const int units = plan.start[1];
    probe_copy_q_kernel<<<(units + PC_THREADS - 1) / PC_THREADS, PC_THREADS, 0, s>>>(
        plan.seg[0], units, B);
    return (int)cudaGetLastError();
  }
  const int bytes = plan.sink_blocks ? (nu + ndr) * PC_SINK_ENVS * 4 : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  probe_copy_kernel<<<plan.sink_block0 + plan.sink_blocks, PC_THREADS, bytes, s>>>(plan);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(PC_THREADS)
    probe_copy_one_thread_kernel(PC_PARAMS, int B, int mode, PC_ROWS) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) probe_copy_env(PC_ARGS, B, mode, nq, nv, nu, ndr, ncache, b);
}

extern "C" int probe_copy_one_thread_launch(PC_PARAMS, int B, int mode, PC_ROWS, void* stream) {
  if (!probe_copy_args_ok(B, mode)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + PC_THREADS - 1) / PC_THREADS;
  probe_copy_one_thread_kernel<<<blocks, PC_THREADS, 0, (cudaStream_t)stream>>>(
      PC_ARGS, B, mode, nq, nv, nu, ndr, ncache);
  return (int)cudaGetLastError();
}

#else

extern "C" int probe_copy_host(PC_PARAMS, int B, int mode, PC_ROWS) {
  if (!probe_copy_args_ok(B, mode)) return 1;
  if (B == 0) return 0;
  PcPlan plan;
  if (!probe_copy_plan(PC_ARGS, B, mode, nq, nv, nu, ndr, ncache, &plan)) return 1;
  for (int i = 0; i < plan.start[3]; ++i) pc_segments(plan, i);
  float* sm = new float[(nu + ndr) * PC_SINK_ENVS + 1];
  for (int k = 0; k < plan.sink_blocks; ++k) {  // a sink block's two phases, thread by thread
    for (int t = 0; t < PC_THREADS; ++t) pc_sink_load(plan, k, t, sm);
    for (int t = 0; t < PC_THREADS; ++t) pc_sink_sum(plan, k, t, sm);
  }
  delete[] sm;
  return 0;
}

extern "C" int probe_copy_one_thread_host(PC_PARAMS, int B, int mode, PC_ROWS) {
  if (!probe_copy_args_ok(B, mode)) return 1;
  for (int b = 0; b < B; ++b) probe_copy_env(PC_ARGS, B, mode, nq, nv, nu, ndr, ncache, b);
  return 0;
}

#endif
