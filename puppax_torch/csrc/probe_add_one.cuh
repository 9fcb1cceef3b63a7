// The launch-overhead probe's kernels: y = x + 1 in two designs.
//
// Replaces, as an H100 probe, the Pallas call of
// dev/probe_launch_overhead.py::run (:50), a trivial x + 1 kernel over
// (8 * nb, 8, 128) float32 blocks (nb = 4 and 32) in a 50-step scan, which
// measures what one launch costs. The caller launches it 50 times back to
// back with the state carried (launch i writes the buffer launch i - 1
// read), eagerly and inside one CUDA graph.
//
// What bounds it: at these sizes (128 KB and 1 MB, resident in the 50 MB
// L2 across the chain) the launch, not the 8 bytes each element moves: a
// graphed kernel node costs ~1.4-1.6 us on the card whatever it does.
//
// 1. add_one_kernel, one element per thread (the first port, kept as the
//    A/B baseline): 1024-thread blocks, one per 1024 elements, a plain
//    <<<>>> launch.
//
// 2. add_one_pdl_kernel, the redesign for Hopper's launch path. Its body
//    moves 16 bytes a thread at a time (float4) where both pointers are
//    16-byte aligned, with a scalar tail for the last n % 4 elements (all
//    scalar where a pointer is not aligned), in a grid-stride loop over a
//    grid sized to the card (per_sm blocks of `threads` threads on each
//    SM; the SM count read once). It is launched with cudaLaunchKernelEx
//    and, when asked, programmatic dependent launch (PDL:
//    cudaLaunchAttributeProgrammaticStreamSerialization): each grid first
//    lets the next grid in the stream launch (griddepcontrol.
//    launch_dependents), then waits (griddepcontrol.wait) until the grid
//    before it has finished and its writes are visible, before its first
//    global read or write. The next launch's set-up and block scheduling
//    then overlap this grid's tail, and the results stay exact: no
//    element is read before its producer finished. Without the attribute
//    both instructions return at once. Stream capture into a CUDA graph
//    turns the attribute into programmatic edges (CUDA 12.3 and later);
//    add_one_capture_edges counts them in the graph being captured.
//
// The same source builds with g++ (no __CUDACC__): add_one_host() loops
// over the elements, and add_one_pdl_host() runs the redesign's threads
// one after another on a grid of ADD_ONE_HOST_THREADS threads, so its
// alignment test, strides and tail are the card's code path.

#pragma once

#include <stdint.h>

#include "common.cuh"

#define ADD_ONE_THREADS 1024
#define ADD_ONE_HOST_THREADS 96

#ifdef __CUDACC__
typedef float4 add_one_quad;
#else
struct add_one_quad {
  float x, y, z, w;
};
#endif

// thread t of T in the redesign: quads t, t + T, ... while both pointers
// are 16-byte aligned, then the tail's elements (every element otherwise)
PUPPAX_HD static inline void add_one_span(const float* x, float* y, int n, long T, long t) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long quads = aligned ? n / 4 : 0;
  const add_one_quad* x4 = (const add_one_quad*)x;
  add_one_quad* y4 = (add_one_quad*)y;
  for (long i = t; i < quads; i += T) {
    add_one_quad v = x4[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    y4[i] = v;
  }
  for (long i = quads * 4 + t; i < n; i += T) y[i] = x[i] + 1.0f;
}

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

__global__ void __launch_bounds__(ADD_ONE_THREADS)
    add_one_pdl_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  add_one_span(x, y, n, (long)gridDim.x * blockDim.x,
               (long)blockIdx.x * blockDim.x + threadIdx.x);
}

// the redesign's grid: per_sm blocks on each SM (a negative cudaError on
// failure)
extern "C" int add_one_pdl_grid(int threads, int per_sm) {
  static int sms = 0;  // read once
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -(int)e;
  }
  if (threads <= 0 || threads > ADD_ONE_THREADS || threads % 32 || per_sm <= 0)
    return -(int)cudaErrorInvalidValue;
  return sms * per_sm;
}

extern "C" int add_one_pdl_launch(const float* x, float* y, int n, int threads, int per_sm,
                                  int pdl, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = add_one_pdl_grid(threads, per_sm);
  if (grid <= 0) return -grid;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, add_one_pdl_kernel, x, y, n);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// the toolkit the library was built with (out[0], CUDART_VERSION), the
// runtime's version (out[1]) and the CUDA driver's (out[2])
extern "C" int add_one_versions(int* out) {
  out[0] = CUDART_VERSION;
  cudaError_t e = cudaRuntimeGetVersion(&out[1]);
  if (e == cudaSuccess) e = cudaDriverGetVersion(&out[2]);
  return (int)e;
}

// The graph being captured on `stream`: its edges in all (out[0]) and its
// programmatic edges (out[1]); a cudaError (cudaErrorStreamCaptureInvalidated
// where the stream is not capturing).
extern "C" int add_one_capture_edges(void* stream, int* out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  unsigned long long id = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id, &graph, nullptr,
                                           nullptr, nullptr);
#else
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id, &graph, nullptr,
                                           nullptr);
#endif
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorStreamCaptureInvalidated;
  size_t count = 0;
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(graph, nullptr, nullptr, nullptr, &count);
#else
  e = cudaGraphGetEdges_v2(graph, nullptr, nullptr, nullptr, &count);
#endif
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)count;
  out[1] = 0;
  if (count == 0) return 0;
  cudaGraphNode_t* from = new cudaGraphNode_t[count];
  cudaGraphNode_t* to = new cudaGraphNode_t[count];
  cudaGraphEdgeData* data = new cudaGraphEdgeData[count];
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(graph, from, to, data, &count);
#else
  e = cudaGraphGetEdges_v2(graph, from, to, data, &count);
#endif
  if (e == cudaSuccess)
    for (size_t i = 0; i < count; ++i)
      out[1] += data[i].type == cudaGraphDependencyTypeProgrammatic;
  delete[] from;
  delete[] to;
  delete[] data;
  return (int)e;
}

#else

extern "C" int add_one_host(const float* x, float* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = x[i] + 1.0f;
  return 0;
}

// the card's launch checks, then the redesign's threads in turn
extern "C" int add_one_pdl_host(const float* x, float* y, int n, int threads, int per_sm,
                                int pdl) {
  (void)pdl;
  if (n < 0 || threads <= 0 || threads > ADD_ONE_THREADS || threads % 32 || per_sm <= 0)
    return 1;
  const long T = ADD_ONE_HOST_THREADS;
  for (long t = 0; t < T; ++t) add_one_span(x, y, n, T, t);
  return 0;
}

#endif
