#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

What it runs, at the defaults of ``puppax_torch/configs/experiment.py``
(the flat Pupper v3, 4096 envs with domain randomization, 5 physics
substeps per env step, episode length 1000, unroll length 20, policy MLP
4 x 128 elu; the weights are random, made from ``--seed``):

1. the card's ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build of the wrapped env-step kernel (K3) from the checkout's
   sources with nvcc for sm_90a, with its wall time and ptxas summary;
3. kernel against plain: after a few kernel steps from reset, one wrapped
   step through ``wrapped_step`` (the kernel) and ``wrapped_step_rows``
   (its plain PyTorch version) on the same inputs, held at the parity
   tolerances env by env; then both timed on those inputs;
4. the main path: ``FastLane.unroll`` with T=20, three times after one
   warm-up, timed with CUDA events, with the kernel's launch count read
   over exactly those three unrolls;
5. one JSON line per run of kernels and, last, the device JSON line.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is visible or when it is
run outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_UNROLL = 20
N_UNROLLS = 3
WARM_STEPS = 5  # kernel steps from reset before the kernel/plain check
MAX_DIFFERING_ENVS = 4


def fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_outputs(s, es, aux_rows, got, want):
    """Hold the kernel's 5 output blocks against the plain version's at the
    parity tolerances, env by env. Returns (per-block max error, list of
    (env, what) for the envs that differ, overall max error)."""
    import torch

    names = ("q", "v", "env", "wrap", "aux")
    for name, g, w in zip(names, got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"kernel output block {name} holds NaN/inf")
        if not torch.isfinite(w).all():
            raise AssertionError(f"plain output block {name} holds NaN/inf")
    err = {n: (g - w).abs() for n, g, w in zip(names, got, want)}
    scale_v = want[1].abs().amax(0, keepdim=True).clamp_min(1.0)
    tol_rows = {
        "q": torch.full_like(got[0], 5e-5),
        "v": 5e-4 * scale_v.expand_as(got[1]),
        "env": torch.full_like(got[2], 1e-4),
        "wrap": torch.zeros_like(got[3]),
        "aux": torch.full_like(got[4], 2e-4),
    }
    tol_env = tol_rows["env"]
    for name, tol in (("obs_history", 2e-4), ("action_buffer", 1e-6),
                      ("command", 1e-6), ("desired_z", 1e-6), ("last_act", 1e-6),
                      ("feet_air_time", 1e-5), ("last_contact", 0.0), ("step", 0.0)):
        r0, n = es.env_rows[name]
        tol_env[r0 : r0 + n] = tol
    r0, n = es.env_rows["last_vel"]
    tol_env[r0 : r0 + n] = 5e-4 * scale_v
    tol_aux = tol_rows["aux"]
    for name in ("done", "truncation"):
        tol_aux[aux_rows[name][0]] = 0.0
    r0, n = aux_rows["rewards"]
    tol_aux[r0 : r0 + n] = 2e-4 * want[4][r0 : r0 + n].abs().clamp_min(1.0)

    differing = {}  # env -> the first comparison that failed
    for i, name in enumerate(names):
        bad = err[name] > tol_rows[name]
        for b in torch.nonzero(bad.any(0)).flatten().tolist():
            r = int(torch.argmax(err[name][:, b] - tol_rows[name][:, b]))
            differing.setdefault(b, f"{name} row {r}: kernel {float(got[i][r, b])!r} "
                                    f"plain {float(want[i][r, b])!r}")
    per_block = {n: float(e.max()) for n, e in err.items()}
    return per_block, sorted(differing.items()), max(per_block.values())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device found (torch.cuda.is_available() is False); "
             "this script runs the port on an NVIDIA GPU")
    if not os.path.isfile(os.path.join(HERE, "puppax_torch", "__init__.py")):
        fail(f"no puppax_torch package beside {__file__}: run it from a checkout")
    sys.path.insert(0, HERE)

    from puppax_torch.configs import DomainRandomizationConfig, EnvConfig, TrainConfig
    from puppax_torch.env import soa_env
    from puppax_torch.env.domain_randomization import domain_randomize
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.kernels import build
    from puppax_torch.train import networks, running_statistics

    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # ---- the default training configuration, on the card ----
    env_cfg, dr_cfg, tc = EnvConfig(), DomainRandomizationConfig(), TrainConfig()
    B = tc.num_envs
    g = torch.Generator(device=device).manual_seed(args.seed)
    env = PupperV3Env.from_config(env_cfg, device=device)
    ranges = {k: v for k, v in vars(dr_cfg).items() if k != "enabled"}
    wrapped = wrap_for_training(
        env, tc.episode_length,
        randomization_fn=lambda m, gen, n: domain_randomize(m, gen, n, **ranges),
        generator=g, num_envs=B,
    )
    nets = networks.make_ppo_networks(
        env.observation_size, env.action_size, tc.policy_hidden_layer_sizes,
        tc.value_hidden_layer_sizes, tc.activation, device=device, generator=g,
    )
    normalizer = running_statistics.init_state(env.observation_size, device=device)
    params = (normalizer, nets.policy_network)
    lane = FastLane(wrapped)
    s, es, n_sub, L = env._s, env._es, env._n_substeps, tc.episode_length
    print(f"config: envs {B}, substeps {n_sub}, episode {L}, unroll {T_UNROLL}, "
          f"obs {env.observation_size}, policy {tc.policy_hidden_layer_sizes}, "
          f"value {tc.value_hidden_layer_sizes} (built, not run), DR on", flush=True)

    # ---- build ----
    t0 = time.perf_counter()
    build.wrapped_step_library(s, es, n_sub, L)
    info = build.last_build
    print(f"build: K3 wrapped_step, {info['lines']} generated lines, generate "
          f"{info['generate_seconds']:.1f} s, nvcc {info['compile_seconds']:.1f} s, "
          f"cached {info['cached']}, wall {time.perf_counter() - t0:.1f} s", flush=True)
    log_path = os.path.join(info["dir"], "build.log")
    if os.path.exists(log_path):
        for line in open(log_path).read().splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print("  ptxas:" + line.split(":", 1)[-1].rstrip())

    # ---- kernel against plain ----
    state = wrapped.reset(B, generator=g)
    state, _ = lane.unroll(state, params, generator=g, T=WARM_STEPS)
    carry = lane.carry_from_state(state)
    noise, _ = lane.draw_noise_block(g, B, 1)
    eps = torch.randn((env.action_size, B), generator=g, device=device)
    r0, n = es.env_rows["obs_history"]
    with torch.no_grad():
        act, _, _ = lane.policy_rows(normalizer, nets.policy_network)(
            carry["env"][r0 : r0 + n], eps
        )
    blocks = [carry["q"], carry["v"], act, carry["env"], noise[0].contiguous(),
              carry["dr"], carry["first"], carry["wrap"]]
    got = soa_env.wrapped_step(s, es, n_sub, L, *blocks)
    torch.cuda.synchronize()
    want = soa_env.wrapped_step_rows(s, es, n_sub, L, *blocks)
    torch.cuda.synchronize()
    aux_rows = soa_env.aux_row_map(es)
    per_block, differing, max_err = compare_outputs(s, es, aux_rows, got, want)
    c0, cn = es.env_rows["last_contact"]
    in_contact = int((got[2][c0 : c0 + cn] > 0.5).any(0).sum())
    print(f"kernel vs plain at {B} envs after {WARM_STEPS} kernel steps "
          f"({in_contact} envs with a foot on the floor): max abs err per block "
          + json.dumps(per_block), flush=True)
    for b, what in differing:
        print(f"  env {b} differs: {what}")
    if len(differing) > MAX_DIFFERING_ENVS:
        raise AssertionError(f"{len(differing)} envs differ (limit {MAX_DIFFERING_ENVS})")
    if in_contact == 0:
        raise AssertionError("no env touches the floor: the contact path went unchecked")

    def kernel_step():
        soa_env.wrapped_step(s, es, n_sub, L, *blocks)

    def plain_step():
        soa_env.wrapped_step_rows(s, es, n_sub, L, *blocks)

    plain_ms = [cuda_ms(plain_step, 1)]
    kernel_ms = [cuda_ms(kernel_step, 20), cuda_ms(kernel_step, 20)]
    plain_ms.append(cuda_ms(plain_step, 1))
    print(f"step at {B} envs: kernel {statistics.median(kernel_ms):.4f} ms "
          f"(runs {kernel_ms}), plain {statistics.median(plain_ms):.1f} ms (runs {plain_ms})",
          flush=True)

    # ---- the main path: FastLane.unroll, T=20 ----
    state = wrapped.reset(B, generator=g)
    state, _ = lane.unroll(state, params, generator=g, T=T_UNROLL)  # warm-up
    torch.cuda.synchronize()
    soa_env.wrapped_step.launches = 0
    unroll_ms, datas = [], []
    for _ in range(N_UNROLLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, data = lane.unroll(state, params, generator=g, T=T_UNROLL)
        end.record()
        torch.cuda.synchronize()
        unroll_ms.append(start.elapsed_time(end))
        datas.append(data)
    launches = soa_env.wrapped_step.launches
    med = statistics.median(unroll_ms)
    print(f"unroll T={T_UNROLL} x {B} envs: median {med:.3f} ms (runs {unroll_ms}), "
          f"{B * T_UNROLL / (med / 1000.0):.0f} env-steps/s", flush=True)
    print(f"kernel launches in the {N_UNROLLS} unrolls: {launches}", flush=True)
    if launches != N_UNROLLS * T_UNROLL:
        raise AssertionError(f"expected {N_UNROLLS * T_UNROLL} kernel launches, got {launches}")
    for data in datas:
        if (data.observation.shape != (T_UNROLL, B, env.observation_size)
                or data.action.shape != (T_UNROLL, B, env.action_size)):
            raise AssertionError(f"unroll shapes {tuple(data.observation.shape)}, "
                                 f"{tuple(data.action.shape)}")
        for name, x in (("obs", data.observation), ("reward", data.reward),
                        ("log_prob", data.policy_extras["log_prob"]),
                        ("next_obs", data.next_observation)):
            if not torch.isfinite(x).all():
                raise AssertionError(f"non-finite {name} in the unroll")
        if not (data.action.abs() <= 1).all():
            raise AssertionError("an action outside [-1, 1]")
    done = torch.stack([1.0 - d.discount for d in datas])
    trunc = torch.stack([d.truncation for d in datas])
    reward = torch.stack([d.reward for d in datas])
    done_frac = float(done.mean())
    print(f"done fraction per step {done_frac:.5f}, truncations {int(trunc.sum())}, "
          f"mean reward {float(reward.mean()):.5f}", flush=True)
    if not 0.0 <= done_frac < 0.5 or int(trunc.sum()) != 0:
        raise AssertionError("implausible episode ends for a fresh 1000-step episode")
    if not torch.isfinite(state.qpos).all():
        raise AssertionError("non-finite final qpos")

    kernels = [{
        "name": "wrapped_step",
        "route": "cuda",
        "source": "puppax_torch/csrc/wrapped_step.cuh",
        "replaces": "puppax/env/soa_env.py:877",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": statistics.median(kernel_ms),
        "plain_ms": statistics.median(plain_ms),
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
