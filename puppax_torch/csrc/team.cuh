// Helpers of the team kernels (physics_step_team.cuh, env_step_team.cuh,
// fused_unroll_team.cuh):
// a block serves 32 envs, one per lane, and its TEAM_W warps split each
// env's program (puppax_torch/kernels/team.py writes each warp's stream into
// its own case of a switch (warp) in the generated body, and #defines TEAM_W
// and the shared memory layout).
//
// Shared memory is one float array of [rows][32], the lane fastest: the
// values that cross warps (SH(slot)), the line search's stacked rows, and the
// double-buffered row terms of its sums (TEAM_TERM(buffer, row)). A bool or
// int crosses as a float (team_bool, team_int read it back exactly). A box
// model's body keeps its indexed arrays in a global scratch instead (SCR).
//
// On the card TEAM_BAR() is the named barrier 1 over the block's 32 * TEAM_W
// threads. The same source builds with g++ (no __CUDACC__): team_host_run()
// then runs TEAM_W std::threads, one per warp, each running its stream for
// every lane of every 32-env group in turn, with a C++20 std::barrier for
// TEAM_BAR() and one array for the group's shared memory.

#pragma once

#include "common.cuh"

#define SH(i) sh[(i) * 32 + lane]
#define TEAM_TERM(buf, r) sh[(TEAM_TERMS + (buf) * TEAM_TERM_ROWS + (r)) * 32 + lane]
// A row of the global scratch of a body with TEAM_SCRATCH_ROWS (a box model's
// indexed arrays and their row terms): each 32-env group's rows together,
// [group][row][32], the lane fastest, so a warp's read or write of a row
// is one 128-byte line.
#define SCR(r) scr[((size_t)(b >> 5) * TEAM_SCRATCH_ROWS + (r)) * 32 + lane]

static inline PUPPAX_HD bool team_bool(float x) { return x != 0.0f; }
static inline PUPPAX_HD int team_int(float x) { return (int)x; }

#ifdef __CUDACC__

#define TEAM_FN __device__
#define TEAM_PRAGMA(x) _Pragma(#x)
#define TEAM_BAR_PARAM
#define TEAM_BAR_ARG
#define TEAM_BAR() asm volatile("bar.sync 1, %0;" ::"r"(32 * TEAM_W) : "memory")

#else

#include <barrier>
#include <thread>
#include <vector>

#define TEAM_FN
#define TEAM_PRAGMA(x)
#define TEAM_BAR_PARAM , std::barrier<>& team_bar
#define TEAM_BAR_ARG , team_bar
#define TEAM_BAR() team_bar.arrive_and_wait()

// body(b, warp, lane, sh, barrier) for b over ceil(B / 32) groups of 32
// lanes: every lane of a group runs (lanes past B too), as on the card.
template <class Body>
static int team_host_run(int B, int n_warps, int shared_floats, Body body) {
  std::vector<float> sh(shared_floats);
  std::barrier<> bar(n_warps);
  std::vector<std::thread> warps;
  for (int warp = 0; warp < n_warps; ++warp)
    warps.emplace_back([&, warp] {
      for (int g = 0; g * 32 < B; ++g)
        for (int lane = 0; lane < 32; ++lane)
          body(g * 32 + lane, warp, lane, sh.data(), bar);
    });
  for (auto& t : warps) t.join();
  return 0;
}

#endif
