// Launch shell of the team fused unroll kernel (team K4).
//
// Replaces puppax/env/fused_unroll.py::build_unroll_kernel (:152 / :346),
// the Pallas TPU kernel that runs a whole T-step rollout unroll in one
// call, as fused_unroll.cuh (the one-thread K4, kept as the A/B baseline)
// does, and computes the same function bit for bit: per step the policy
// observation from the carried env block (plus the gait clock's cos and
// sin), the policy MLP with the observation normalizer folded into its
// first layer, the NormalTanh sample from the pre-drawn eps, the wrapped
// env step and the clock's tick.
//
// Design for the H100: a block of TEAM_W warps serves 32 envs, one per
// lane, and the warps share each env's work (csrc/team.cuh). Per step t:
//
//   (a) the observation rows, split across the warps, into a shared
//       activation buffer [k][32] (lane fastest) and into obs_ts;
//   (b) the MLP, layer by layer: the layer's outputs are cut into chunks
//       of K4_R and chunk c belongs to warp c % TEAM_W; a thread sums the
//       K4_R outputs of its chunk for its lane's env at once (K4_R
//       independent chains in registers), k = 0..n_in-1 in order,
//       acc = acc + w * x, then + bias, as env/fused_unroll.py::mlp_rows.
//       Activations come from shared memory; the weights, transposed to
//       (n_in, n_out) so a chunk's K4_R weights of one k are adjacent, come
//       through the read-only cache, the same address for every lane of a
//       warp (a broadcast). An elementwise activation is applied by the
//       thread that owns the unit; softmax, after a barrier, takes its
//       in-order max and sum over all features in every warp and each warp
//       writes its own units. Two ping-pong buffers [2][width][32];
//   (c) the NormalTanh head, its actions split across the warps, each
//       action's log-prob term into shared memory; after a barrier warp 0
//       sums the terms over the actions in order;
//   (d) after a barrier, the wrapped env step: K3's program split across
//       the warps by kernels/team.py (wrapped_step_team_body);
//   (e) after a barrier, the clock's tick from the aux done row, in every
//       warp (the phase is kept in each warp's registers).
//
// The MLP's buffers and the head's terms alias the team body's shared
// array: barriers part them from the body. The array is the larger of the
// two needs: TEAM_SHARED_FLOATS for the body, 2 x width x 32 floats for the
// MLP (width: the policy's widest layer, a runtime int). A bar.sync also
// orders the block's global memory accesses, so the carry, the action and
// aux that one warp stores are read by the others after the barrier. The
// carry ping-pongs between the final buffers and a scratch set as in
// fused_unroll.cuh (the body's pointers are __restrict__). Grid
// ceil(B / 32), __launch_bounds__(32 * TEAM_W, 1). Lanes past B compute
// env B - 1 and store nothing, so every thread reaches every barrier.
//
// What bounds it: the env step's heaviest warp stream and its barriers (as
// team K2), not DRAM. The MLP is 61,440 multiply-adds per env per step
// for 72 -> 4 x 128 -> 24, 1 / TEAM_W of them per warp.
//
// K4_MLP_ONLY (a probe variant, kernels/cgen.py::fused_unroll_team_body)
// leaves the env step out: the carry is not advanced, the clock ticks
// without a done, and nothing but the per-step outputs is written.
//
// The same source builds with g++ (no __CUDACC__): fused_unroll_team_host()
// then runs TEAM_W std::threads, one per warp (csrc/team.cuh).

#pragma once

#include "team.cuh"

#include PUPPAX_KERNEL_BODY

#include "fused_policy.cuh"

// A body whose indexed arrays live outside shared memory (a box model's:
// TEAM_SCRATCH_ROWS rows per env, csrc/team.cuh's SCR) reads and writes them
// in a global scratch of TEAM_SCRATCH_ROWS * 32 floats per block, its own
// operand (not the carry's scratch set, which the pointers q_s .. wrap_s
// name): the caller allocates it and passes it with
// fused_unroll_team_set_scratch before launching
// (puppax_torch/kernels/build.py, bind_scratch); the host build allocates
// its own. Each of the T steps reuses it: the barrier after a step's env
// step (a bar.sync, which orders the block's global accesses too) puts
// every read of a row in step t before any store to it in step t + 1.
#ifdef TEAM_SCRATCH_ROWS
#define TEAM_SCR , scr
#else
#define TEAM_SCRATCH_ROWS 0
#define TEAM_SCR
#endif

extern "C" int fused_unroll_team_scratch_rows() { return TEAM_SCRATCH_ROWS; }

#ifndef K4_MLP_ONLY
#define K4_MLP_ONLY 0
#endif

// unit k of activation buffer p, for this thread's lane
#define K4_H(p, k) sh[((p) * width + (k)) * 32 + lane]

static inline PUPPAX_HD int k4_width(const K4Mlp& m) {
  int w = 0;
  for (int i = 0; i <= m.n_layers; ++i) w = m.dims[i] > w ? m.dims[i] : w;
  return w;
}

// floats of shared memory one block uses for this policy
static inline int k4_team_shared_floats(const K4Mlp& m) {
  const int mlp = 2 * k4_width(m) * 32;
  return TEAM_SHARED_FLOATS > mlp ? TEAM_SHARED_FLOATS : mlp;
}

// this warp's outputs of one layer, from buffer in into buffer out; the
// weights wt are (n_in, n_out) row-major, then the bias
TEAM_FN static inline void k4_layer(const float* __restrict__ wt, int n_in, int n_out, int act,
                                    bool hidden, float* sh, int in, int out, int width,
                                    int warp, int lane) {
  const float* bias = wt + (long)n_in * n_out;
  for (int o0 = warp * K4_R; o0 < n_out; o0 += TEAM_W * K4_R) {
    float acc[K4_R];
    int col[K4_R];  // the chunk's outputs; past n_out the last one, not stored
    TEAM_PRAGMA(unroll)
    for (int j = 0; j < K4_R; ++j) {
      acc[j] = 0.0f;
      col[j] = o0 + j < n_out ? o0 + j : n_out - 1;
    }
    TEAM_PRAGMA(unroll 4)
    for (int k = 0; k < n_in; ++k) {
      const float x = K4_H(in, k);
      const float* wk = wt + (long)k * n_out;
      TEAM_PRAGMA(unroll)
      for (int j = 0; j < K4_R; ++j) acc[j] = acc[j] + K4_LDG(wk + col[j]) * x;
    }
    TEAM_PRAGMA(unroll)
    for (int j = 0; j < K4_R; ++j) {
      if (o0 + j < n_out) {
        const float y = acc[j] + K4_LDG(bias + o0 + j);
        K4_H(out, o0 + j) = hidden && act != 4 ? k4_unit(act, y) : y;
      }
    }
  }
}

// softmax over the n units of buffer src into buffer dst: the max and the
// sum in order over all units in every warp, each warp's units written
TEAM_FN static inline void k4_softmax(int n, float* sh, int src, int dst, int width, int warp,
                                      int lane) {
  float m = K4_H(src, 0);
  for (int k = 1; k < n; ++k) m = pmax(m, K4_H(src, k));
  float total = expf(K4_H(src, 0) - m);
  for (int k = 1; k < n; ++k) total = total + expf(K4_H(src, k) - m);
  for (int o0 = warp * K4_R; o0 < n; o0 += TEAM_W * K4_R)
    for (int o = o0; o < o0 + K4_R && o < n; ++o) K4_H(dst, o) = expf(K4_H(src, o) - m) / total;
}

// T steps of env b: this warp's share
TEAM_FN inline void fused_unroll_team_env(K4_PARAMS, int B, int T, const K4Mlp& mlp, int gait,
                                          int b, int warp, int lane, float* sh,
                                          float* scr TEAM_BAR_PARAM) {
  const long Bl = B;
  const int bl = b < B ? b : B - 1;  // lanes past B compute env B - 1, store nothing
  const bool live = b < B;
  const int width = k4_width(mlp);
  const int obs_dim = K4_HIST + (gait ? 2 : 0);
  float phase = gait ? phase0[bl] : 0.0f;
  const float* q = q0;
  const float* v = v0;
  const float* env = env0;
  const float* wrap = wrap0;
  (void)q;
  (void)v;
  (void)wrap;
  (void)scr;
  for (int t = 0; t < T; ++t) {
    // the last step writes the final buffers; the steps before alternate
    const bool to_final = ((T - 1 - t) % 2) == 0;
    float* q_o = to_final ? q_f : q_s;
    float* v_o = to_final ? v_f : v_s;
    float* env_o = to_final ? env_f : env_s;
    float* wrap_o = to_final ? wrap_f : wrap_s;
    (void)q_o;
    (void)v_o;
    (void)env_o;
    (void)wrap_o;

    // (a) the observation: the history rows, then the clock before its tick
    float* obs_t = obs_ts + t * obs_dim * Bl;
    for (int i = warp; i < K4_HIST; i += TEAM_W) {
      const float x = env[(K4_OBS_R0 + i) * Bl + bl];
      K4_H(0, i) = x;
      if (live) obs_t[i * Bl + b] = x;
    }
    if (gait && warp == 0) {
      const float c = cosf(phase), s = sinf(phase);
      K4_H(0, K4_HIST) = c;
      K4_H(0, K4_HIST + 1) = s;
      if (live) {
        obs_t[K4_HIST * Bl + b] = c;
        obs_t[(K4_HIST + 1) * Bl + b] = s;
      }
    }
    TEAM_BAR();

    // (b) the folded MLP, each layer from buffer cur into 1 - cur
    int cur = 0;
    const float* wt = weights;
    for (int l = 0; l < mlp.n_layers; ++l) {
      const int n_in = mlp.dims[l], n_out = mlp.dims[l + 1];
      const bool hidden = l != mlp.n_layers - 1;
      k4_layer(wt, n_in, n_out, mlp.act, hidden, sh, cur, 1 - cur, width, warp, lane);
      wt += (long)n_out * (n_in + 1);
      cur = 1 - cur;
      TEAM_BAR();
      if (hidden && mlp.act == 4) {
        k4_softmax(n_out, sh, cur, 1 - cur, width, warp, lane);
        cur = 1 - cur;
        TEAM_BAR();
      }
    }

    // (c) the NormalTanh head on the pre-drawn eps; the log-prob summed in order
    float* act = act_ts + t * K4_NU * Bl;
    float* raw = raw_ts + t * K4_NU * Bl;
    const float* eps_t = eps + t * K4_NU * Bl;
    for (int i = warp; i < K4_NU; i += TEAM_W) {
      const K4Sample smp = k4_sample(K4_H(cur, i), K4_H(cur, K4_NU + i), eps_t[i * Bl + bl]);
      if (live) {
        act[i * Bl + b] = smp.act;
        raw[i * Bl + b] = smp.pre;
      }
      K4_H(1 - cur, i) = smp.term;
    }
    TEAM_BAR();
    if (warp == 0) {
      float logp = K4_H(1 - cur, 0);
      for (int i = 1; i < K4_NU; ++i) logp = logp + K4_H(1 - cur, i);
      if (live) logp_ts[t * Bl + b] = logp;
    }
    TEAM_BAR();

#if K4_MLP_ONLY
    if (gait) phase = k4_tick(phase, 0.0f);
#else
    // (d) the wrapped env step (K3's program across the warps) on this
    // step's action and noise
    float* aux_t = aux_ts + t * K4_NAUX * Bl;
    wrapped_step_team_body(q, v, act, env, noise + t * K4_NNOISE * Bl, dr, first, wrap, q_o,
                           v_o, env_o, wrap_o, aux_t, B, b, warp, lane, sh TEAM_SCR TEAM_BAR_ARG);
    TEAM_BAR();

    // (e) the gait clock ticks, and restarts on the effective done
    if (gait) phase = k4_tick(phase, aux_t[K4_DONE_ROW * Bl + bl]);
    q = q_o;
    v = v_o;
    env = env_o;
    wrap = wrap_o;
#endif
  }
  if (gait && live && warp == 0) phase_f[b] = phase;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(32 * TEAM_W, 1)
    fused_unroll_team_kernel(K4_PARAMS, int B, int T, K4Mlp mlp, int gait, float* scr) {
  extern __shared__ float sh[];
  const int lane = threadIdx.x & 31;
  fused_unroll_team_env(K4_ARGS, B, T, mlp, gait, blockIdx.x * 32 + lane, threadIdx.x >> 5,
                        lane, sh, scr);
}

static float* team_scratch = nullptr;

extern "C" int fused_unroll_team_set_scratch(void* scr) {
  team_scratch = (float*)scr;
  return 0;
}

extern "C" int fused_unroll_team_launch(K4_PARAMS, int B, K4_INTS, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (TEAM_SCRATCH_ROWS && team_scratch == nullptr) return (int)cudaErrorInvalidValue;
  const K4Mlp mlp = k4_mlp(T, n_layers, act, gait, d0, d1, d2, d3, d4, d5, d6, d7, d8);
  static bool sized = false;
  if (!sized) {  // the most any policy needs
    K4Mlp widest = mlp;
    widest.n_layers = 0;
    widest.dims[0] = K4_MAX_WIDTH;
    const cudaError_t e = cudaFuncSetAttribute(fused_unroll_team_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               k4_team_shared_floats(widest) * 4);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  fused_unroll_team_kernel<<<(B + 31) / 32, 32 * TEAM_W, k4_team_shared_floats(mlp) * 4,
                             (cudaStream_t)stream>>>(K4_ARGS, B, T, mlp, gait,
                                                                team_scratch);
  return (int)cudaGetLastError();
}

#else

extern "C" int fused_unroll_team_host(K4_PARAMS, int B, K4_INTS) {
  if (B <= 0 || T <= 0) return 0;
  const K4Mlp mlp = k4_mlp(T, n_layers, act, gait, d0, d1, d2, d3, d4, d5, d6, d7, d8);
  std::vector<float> scratch((size_t)TEAM_SCRATCH_ROWS * ((B + 31) / 32) * 32);
  float* scr = scratch.data();
  return team_host_run(B, TEAM_W, k4_team_shared_floats(mlp),
                       [&](int b, int warp, int lane, float* sh, std::barrier<>& bar) {
                         fused_unroll_team_env(K4_ARGS, B, T, mlp, gait, b, warp, lane, sh, scr,
                                               bar);
                       });
}

#endif
