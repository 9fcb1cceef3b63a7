// Launch shell of the one-thread fused unroll kernel (K4): the A/B baseline
// of team K4 (fused_unroll_team.cuh), which env/fused_unroll.py::unroll
// launches; this one is reached through unroll_one_thread only.
//
// Replaces puppax/env/fused_unroll.py::build_unroll_kernel, the Pallas TPU
// kernel that runs a whole T-step rollout unroll in one call: per step the
// policy observation from the carried env block (plus the gait clock's cos
// and sin), the policy MLP with the observation normalizer folded into its
// first layer, the NormalTanh sample from pre-drawn eps, the wrapped env
// step and the gait clock's tick, the carry (q, v, env, wrap, phase)
// resident across the steps. The TPU kernel's grid (env tiles, T) with the
// carry in revisited VMEM blocks becomes a loop over t inside one thread
// per env: __launch_bounds__(128), grid ceil(B / 128), a b < B guard, no
// padding. Every block is (rows, B) row-major float32 (the per-step inputs
// and outputs (T, rows, B)), so a warp's loads coalesce. No value crosses
// threads, so there is no barrier.
//
// The env step is K3's generated body (wrapped_step_body, from the same
// emission; kernels/cgen.py::fused_unroll_body adds the layout and head
// constants; the policy side is fused_policy.cuh), called once per step.
// Its pointers are __restrict__, so no call gets one buffer as both input
// and output: the carry ping-pongs between the final buffers and a scratch
// set, and the last step writes the final ones. The MLP is hand-written: each thread keeps its activations in
// float h[2][K4_MAX_WIDTH] (local memory), and reads every weight through
// the read-only cache; all threads of a warp read the same weight, a
// broadcast. One flat weight buffer with the widths as runtime ints serves
// every policy shape with one build. Each output is summed over its inputs
// in order (acc = acc + w * x, then + b) and --fmad=false keeps every
// product and sum rounded apart, as in the plain version
// (env/fused_unroll.py::unroll_rows), so the two agree bit for bit.
//
// What bounds it: K3's registers and spills (168 registers, ~36 KB of
// spills per thread), not DRAM, plus the MLP's serial dot products
// (61,440 multiply-adds per env per step for 72 -> 4 x 128 -> 24) with its
// activations in local memory. This first design does nothing about
// either; team K4 splits both across the warps of a block.
//
// The same source builds with g++ (no __CUDACC__): PUPPAX_HD is then empty
// and fused_unroll_host() loops over the envs on the CPU.

#pragma once

#include "common.cuh"

#include PUPPAX_KERNEL_BODY

#include "fused_policy.cuh"

// the hidden activation on h[0..n), as env/fused_unroll.py::activate
PUPPAX_HD static inline void k4_activate(int act, float* h, int n) {
  if (act == 4) {  // softmax over the features, in order
    float m = h[0];
    for (int k = 1; k < n; ++k) m = pmax(m, h[k]);
    for (int k = 0; k < n; ++k) h[k] = expf(h[k] - m);
    float total = h[0];
    for (int k = 1; k < n; ++k) total = total + h[k];
    for (int k = 0; k < n; ++k) h[k] = h[k] / total;
    return;
  }
  for (int k = 0; k < n; ++k) h[k] = k4_unit(act, h[k]);
}

// T steps of env b
PUPPAX_HD inline void fused_unroll_env(K4_PARAMS, int B, int T, const K4Mlp& mlp, int gait,
                                       int b) {
  float h[2][K4_MAX_WIDTH];
  const long Bl = B;
  const int obs_dim = K4_HIST + (gait ? 2 : 0);
  float phase = gait ? phase0[b] : 0.0f;
  const float* q = q0;
  const float* v = v0;
  const float* env = env0;
  const float* wrap = wrap0;
  for (int t = 0; t < T; ++t) {
    // the last step writes the final buffers; the steps before alternate
    const bool to_final = ((T - 1 - t) % 2) == 0;
    float* q_o = to_final ? q_f : q_s;
    float* v_o = to_final ? v_f : v_s;
    float* env_o = to_final ? env_f : env_s;
    float* wrap_o = to_final ? wrap_f : wrap_s;

    // the policy observation: the history rows, then the clock before its tick
    float* obs_t = obs_ts + t * obs_dim * Bl;
    for (int i = 0; i < K4_HIST; ++i) {
      const float x = env[(K4_OBS_R0 + i) * Bl + b];
      h[0][i] = x;
      obs_t[i * Bl + b] = x;
    }
    if (gait) {
      const float c = cosf(phase), s = sinf(phase);
      h[0][K4_HIST] = c;
      h[0][K4_HIST + 1] = s;
      obs_t[K4_HIST * Bl + b] = c;
      obs_t[(K4_HIST + 1) * Bl + b] = s;
    }

    // the folded MLP: layer l maps h[cur][0..in) to h[1 - cur][0..out)
    int cur = 0;
    long woff = 0;
    for (int l = 0; l < mlp.n_layers; ++l) {
      const int n_in = mlp.dims[l], n_out = mlp.dims[l + 1];
      const float* W = weights + woff;
      const float* bias = W + (long)n_out * n_in;
      for (int o = 0; o < n_out; ++o) {
        const float* w_row = W + (long)o * n_in;
        float acc = 0.0f;
        for (int k = 0; k < n_in; ++k) acc = acc + K4_LDG(w_row + k) * h[cur][k];
        h[1 - cur][o] = acc + K4_LDG(bias + o);
      }
      woff += (long)n_out * (n_in + 1);
      cur = 1 - cur;
      if (l != mlp.n_layers - 1) k4_activate(mlp.act, h[cur], n_out);
    }

    // the NormalTanh head on the pre-drawn eps; the log-prob summed in order
    const float* y = h[cur];
    float* act = act_ts + t * K4_NU * Bl;
    float* raw = raw_ts + t * K4_NU * Bl;
    const float* eps_t = eps + t * K4_NU * Bl;
    float logp = 0.0f;
    for (int i = 0; i < K4_NU; ++i) {
      const K4Sample smp = k4_sample(y[i], y[K4_NU + i], eps_t[i * Bl + b]);
      act[i * Bl + b] = smp.act;
      raw[i * Bl + b] = smp.pre;
      logp = i == 0 ? smp.term : logp + smp.term;
    }
    logp_ts[t * Bl + b] = logp;

    // the wrapped env step (K3's body) on this step's action and noise
    float* aux_t = aux_ts + t * K4_NAUX * Bl;
    wrapped_step_body(q, v, act, env, noise + t * K4_NNOISE * Bl, dr, first, wrap, q_o, v_o,
                      env_o, wrap_o, aux_t, B, b);

    // the gait clock ticks, and restarts on the effective done
    if (gait) {
      phase = k4_tick(phase, aux_t[K4_DONE_ROW * Bl + b]);
    }
    q = q_o;
    v = v_o;
    env = env_o;
    wrap = wrap_o;
  }
  if (gait) phase_f[b] = phase;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
    fused_unroll_kernel(K4_PARAMS, int B, int T, K4Mlp mlp, int gait) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) fused_unroll_env(K4_ARGS, B, T, mlp, gait, b);
}

extern "C" int fused_unroll_launch(K4_PARAMS, int B, K4_INTS, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const K4Mlp mlp = k4_mlp(T, n_layers, act, gait, d0, d1, d2, d3, d4, d5, d6, d7, d8);
  fused_unroll_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(K4_ARGS, B, T, mlp, gait);
  return (int)cudaGetLastError();
}

#else

extern "C" int fused_unroll_host(K4_PARAMS, int B, K4_INTS) {
  const K4Mlp mlp = k4_mlp(T, n_layers, act, gait, d0, d1, d2, d3, d4, d5, d6, d7, d8);
  for (int b = 0; b < B; ++b) fused_unroll_env(K4_ARGS, B, T, mlp, gait, b);
  return 0;
}

#endif
