"""Where one ``FastLane.unroll`` spends its time on the card.

    python -m puppax_torch.tools.profile_unroll [--seed 0] [--table PATH] [--fused]

At the default training configuration (``puppax_torch/configs``: 4096
envs, DR on, 5 substeps, T=20, random policy weights from ``--seed``) it
prints, for the K3 lane or, with ``--fused``, the fused-unroll lane
(``PUPPAX_FUSED_UNROLL=on``):

- each phase of the unroll timed alone, with CUDA events and on the host
  clock: ``draw_noise_block`` (T steps of env noise on the envs' threefry
  key chains), ``draw_eps`` (the T steps' sampling eps), ``carry_from_state``
  and, for the K3 lane, one ``policy_rows`` apply and one team K3
  ``wrapped_step`` launch; for the fused lane, ``fold_normalizer``, one K4
  ``fused_unroll.unroll`` launch (all T steps) and ``_assemble_unroll``;
- the whole unroll, unprofiled, timed with CUDA events (median of 3), and
  the draws' share of it (``draw_noise_block`` + ``draw_eps`` over the
  unroll, both on CUDA events);
- one unroll under ``torch.profiler``: its CUDA-event window, the device's
  busy time in that window (the union of every device activity interval of
  the trace) and the idle share ``1 - busy / window``
  (``profiling.summarize``), plus the profiler's table of device time by
  kernel (also written to ``--table``).

The profiler's host overhead stretches the profiled window, so its idle
share is an upper bound on the unprofiled unroll's.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def _event_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--table", default=None, help="write the profiler table here")
    ap.add_argument("--fused", action="store_true",
                    help="profile the fused-unroll lane (K4) instead of the K3 lane")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from puppax_torch import random
    from puppax_torch.configs import DomainRandomizationConfig, EnvConfig, TrainConfig
    from puppax_torch.env import fused_unroll, soa_env
    from puppax_torch.env.domain_randomization import domain_randomize
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.tools import profiling
    from puppax_torch.train import networks, running_statistics

    if not torch.cuda.is_available():
        raise SystemExit("profile_unroll: no CUDA device found")
    if args.fused:
        os.environ["PUPPAX_FUSED_UNROLL"] = "on"
    device = torch.device("cuda", 0)
    tc, dr_cfg = TrainConfig(), DomainRandomizationConfig()
    B, T, L = tc.num_envs, tc.unroll_length, tc.episode_length
    key_dr, key_net, key_env, key_run = random.split(random.key(args.seed, device), 4).unbind(0)
    env = PupperV3Env.from_config(EnvConfig(), device=device)
    ranges = {k: v for k, v in vars(dr_cfg).items() if k != "enabled"}
    wrapped = wrap_for_training(
        env, L, randomization_fn=lambda m, keys: domain_randomize(m, keys, **ranges),
        randomization_keys=random.split(key_dr, B),
    )
    nets = networks.make_ppo_networks(
        env.observation_size, env.action_size, tc.policy_hidden_layer_sizes,
        tc.value_hidden_layer_sizes, tc.activation, device=device, key=key_net,
    )
    normalizer = running_statistics.init_state(env.observation_size, device=device)
    params = (normalizer, nets.policy_network)
    lane = FastLane(wrapped)
    state = wrapped.reset(random.split(key_env, B))
    for key in random.split(key_run, 2):  # build the kernels, reach a state with contacts
        state, _ = lane.unroll(state, params, key, T)
    torch.cuda.synchronize()

    carry = lane.carry_from_state(state)
    keys = state.info["rng"]
    _, noise, _ = lane.draw_noise_block(keys, T)
    eps = lane.draw_eps(key_run, B, 1)[0].t().contiguous()
    apply = lane.policy_rows(normalizer, nets.policy_network)
    r0, n = lane.es.env_rows["obs_history"]
    obs = carry["env"][r0 : r0 + n]
    with torch.no_grad():
        act, _, _ = apply(obs, eps)
    blocks = [carry["q"], carry["v"], act, carry["env"], noise[0].contiguous(),
              carry["dr"], carry["first"], carry["wrap"]]

    def phase(name, fn, reps):
        print(f"{name}: {_event_ms(fn, reps):.3f} ms CUDA events, "
              f"{_host_ms(fn, reps):.3f} ms host clock", flush=True)

    draws_ms = 0.0
    for name, fn in ((f"draw_noise_block T={T}", lambda: lane.draw_noise_block(keys, T)),
                     (f"draw_eps T={T}", lambda: lane.draw_eps(key_run, B, T))):
        ms = _event_ms(fn, 5)
        draws_ms += ms
        print(f"{name}: {ms:.3f} ms CUDA events, {_host_ms(fn, 5):.3f} ms host clock",
              flush=True)
    phase("carry_from_state", lambda: lane.carry_from_state(state), 5)
    if args.fused:
        policy = nets.policy_network
        fold = lambda: fused_unroll.fold_normalizer(normalizer, policy)  # noqa: E731
        k4_in = [carry[k] for k in ("q", "v", "env", "wrap")] + [
            None, carry["first"], carry["dr"], noise,
            lane.draw_eps(key_run, B, T).transpose(1, 2).contiguous()]

        def k4():
            return fused_unroll.unroll(lane.s, lane.es, lane.n_substeps, L, policy.activation_name,
                                       fold(), *k4_in)

        out = k4()
        final = dict(carry, q=out[0], v=out[1], env=out[2], wrap=out[3])
        last_kick = state.info["kick"]
        phase("fold_normalizer", fold, 20)
        phase(f"fused_unroll (K4) T={T}", k4, 5)
        phase("_assemble_unroll", lambda: lane._assemble_unroll(
            state, final, out[5], out[6], out[7], out[8][:, 0], out[9], last_kick), 5)
    else:
        with torch.no_grad():
            phase("policy_rows", lambda: apply(obs, eps), 20)
        phase("wrapped_step (team K3)", lambda: soa_env.wrapped_step(
            lane.s, lane.es, lane.n_substeps, L, *blocks), 20)
    unroll = [_event_ms(lambda: lane.unroll(state, params, key_run, T), 1)
              for _ in range(3)]
    median = statistics.median(unroll)
    print(f"{'fused-unroll (K4)' if args.fused else 'K3'} lane:")
    print(f"unroll T={T} x {B} envs, unprofiled: median {median:.3f} ms "
          f"CUDA events (runs {unroll})", flush=True)
    print(f"draws (draw_noise_block + draw_eps): {draws_ms:.3f} ms, "
          f"{draws_ms / median:.3f} of the unroll", flush=True)

    for _ in ("warm-up", "measured"):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            lane.unroll(state, params, key_run, T)
            end.record()
            torch.cuda.synchronize()
    summary = profiling.summarize(prof.events(), start.elapsed_time(end))
    if summary["busy_ms"] == 0.0:
        raise SystemExit("profile_unroll: the trace holds no device activity")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    if args.table:
        with open(args.table, "w") as f:
            f.write(table)
    print(table)
    print(f"profiled unroll: window {summary['window_ms']:.3f} ms CUDA events, device busy "
          f"{summary['busy_ms']:.3f} ms, idle share {summary['idle']:.3f}", flush=True)


if __name__ == "__main__":
    main()
