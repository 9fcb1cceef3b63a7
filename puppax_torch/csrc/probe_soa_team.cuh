// Launch shell of the synthetic SoA substep as a team kernel: the substep's
// program split across the warps of a block.
//
// Replaces, as an H100 probe in the production kernels' team design, the
// Pallas call of dev/pallas_soa_probe.py::soa_substep (:103, pallas_call
// :106), whose kernel (substep_like_kernel, :55-97) approximates one physics
// substep's op mix on (8, 128) tiles and asks whether a large straight-line
// per-env body is viable. The body is soa_substep_team_body() from
// puppax_torch/probes/pallas_soa_probe.py (soa_substep_team_body(rounds,
// warps)): the program of probe_soa.cuh (one thread per env, kept as the
// A/B) scheduled across the warps by kernels/team.py, as
// physics_step_team.cuh runs K1's.
//
// What bounds it: not the card's rate (~7k float operations per env against
// 56 rows of bytes) but each env's dependent chain. One thread per env puts
// 4096 envs on one warp per SM, so one of an SM's four schedulers issues
// the whole chain. Here a block of TEAM_W warps serves 32 envs, one per
// lane, each warp running its own stream of every env's program, so the
// SM's schedulers share each env's independent work (the 12 hinge chains,
// each round's 18 products and 18 updates); values that cross warps go
// through one dynamic shared array (TEAM_SHARED_FLOATS * 4 bytes, sized
// once with cudaFuncSetAttribute), and a barrier separates the stages.
// __launch_bounds__(32 * TEAM_W, 1). Every thread reaches every barrier:
// lanes past B compute env B - 1 and store nothing, and the shell never
// returns early.
//
// Blocks are (rows, B) row-major float32: q (19 rows) and v (18 rows) in,
// q_out (19 rows) out. Every operation is the one-thread program's on the
// same operands, so under --fmad=false the team kernel equals the
// one-thread kernel and the plain version bit for bit.
//
// The same source builds with g++ (no __CUDACC__): probe_soa_team_host()
// then runs TEAM_W std::threads per 32-env group (team_host_run).

#pragma once

#include "team.cuh"

#define SOA_PARAMS \
  const float* __restrict__ q, const float* __restrict__ v, float* __restrict__ q_out

#include PUPPAX_KERNEL_BODY

#ifdef __CUDACC__

__global__ void __launch_bounds__(32 * TEAM_W, 1) probe_soa_team_kernel(SOA_PARAMS, int B) {
  extern __shared__ float sh[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  soa_substep_team_body(q, v, q_out, B, blockIdx.x * 32 + lane, warp, lane, sh);
}

extern "C" int probe_soa_team_launch(SOA_PARAMS, int B, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int bytes = TEAM_SHARED_FLOATS * 4;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_soa_team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  probe_soa_team_kernel<<<(B + 31) / 32, 32 * TEAM_W, bytes, (cudaStream_t)stream>>>(q, v,
                                                                                     q_out, B);
  return (int)cudaGetLastError();
}

#else

extern "C" int probe_soa_team_host(SOA_PARAMS, int B) {
  if (B < 0) return 1;
  return team_host_run(B, TEAM_W, TEAM_SHARED_FLOATS,
                       [&](int b, int warp, int lane, float* sh, std::barrier<>& bar) {
                         soa_substep_team_body(q, v, q_out, B, b, warp, lane, sh, bar);
                       });
}

#endif
