"""How much of a step is the loop around the launch? Eager against one CUDA graph.

    python -m puppax_torch.probes.profile_scan [--envs 4096]

The H100 counterpart of ``dev/profile_scan.py`` (``kcall`` :87 /
``pallas_call`` :88), which asked whether the TPU's ~500 us floor per step
was the loop's overhead: 50 steps of a 19-row copy kernel under
``lax.scan``, ``scan(unroll=50)`` and a Python loop under one jit, beside
XLA scans of ``x + 1`` and ``tanh(c) + 1``. Each case here is 50 steps with
the state carried (``common.carried_us``: best of 3 windows, CUDA events):

- ``copy_q`` (``csrc/probe_copy.cuh``, mode q) on the ``(19, B)`` q block,
  held bit for bit against its plain version first: 50 eager launches
  (the TPU's ``pyloop-pallas``) and one CUDA graph of the 50 (its
  ``scan-pallas`` and ``unroll-pallas``: both become one graph here),
  beside ``torch.add(q, 1e-7)`` and the same file's one-thread copy (the
  A/B baseline);
- torch ``x + 1`` on ``(128,)`` and ``tanh(c) + 1`` on ``(B, 512)``, eager
  and graphed (``scan-xla-add``, ``scan-xla-add-big``).

Then the question this asks of the H100 (``unroll_ab``): the K3 lane's
T=20 ``FastLane.unroll_from_draws`` (the policy and one team K3 launch
per step) at B envs, run eagerly and captured once as a ``torch.cuda.CUDAGraph``
and replayed, on draws made once before the timed windows. It prints ms
per unroll for each and ``(eager - graph) / T``, the host's time per step
that the graph removes; the graph's outputs (the final state and every
transition) must equal the eager ones bit for bit, since the same kernels
run on the same inputs. The production call is captured as it is: the
lane was not changed for capture.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Iterator, Tuple

import torch

from puppax_torch.kernels import build
from puppax_torch.probes import common

SMALL_SHAPE = (128,)  # dev/profile_scan.py:50
BIG_WIDTH = 512  # dev/profile_scan.py:51
T_UNROLL = 20  # the K3 lane's unroll length (configs/experiment.py)


def leaves(x, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor in a nest of dataclasses, dicts,
    tuples and lists (a State, a Transition), in a fixed order."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from leaves(x[k], f"{path}[{k!r}]")
    elif isinstance(x, (tuple, list)):
        for i, y in enumerate(x):
            yield from leaves(y, f"{path}[{i}]")


def differing_leaves(got, want):
    """The paths whose tensors differ bit for bit (a NaN equals a NaN), or
    whose nests differ in structure, shape or dtype."""
    g, w = dict(leaves(got)), dict(leaves(want))
    bad = sorted(set(g) ^ set(w))
    for path in sorted(set(g) & set(w)):
        a, b = g[path], w[path]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(path)
        elif not bool(((a == b) | (a != a) & (b != b)).all()):
            bad.append(path)
    return bad


def unroll_ab(lane, state, params, noise, eps, last_kick,
              runs: int = common.RUNS) -> Dict[str, object]:
    """The T-step ``lane.unroll_from_draws`` on the given draws (static
    inputs), eagerly and as one captured CUDA graph: ``eager_ms`` and
    ``graph_ms`` per unroll (best of ``runs``, CUDA events), ``host_ms_per_step``
    (their difference over T) and ``differing`` (``differing_leaves`` of the
    graph's outputs against the eager ones; raises unless empty)."""
    T = noise.shape[0]

    def unroll():
        return lane.unroll_from_draws(state, params, noise, eps, last_kick)

    eager = []
    eager_ms = common.best_ms(lambda: eager.append(unroll()), runs)
    # warm up on a side stream before the capture, as torch.cuda.graphs asks
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        unroll()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = unroll()
    graph_ms = common.best_ms(graph.replay, runs)
    torch.cuda.synchronize()
    differing = differing_leaves(captured, eager[-1])
    if differing:
        raise AssertionError(f"the graphed unroll differs from the eager one in {differing}")
    return dict(T=T, envs=noise.shape[2], eager_ms=eager_ms, graph_ms=graph_ms,
                host_ms_per_step=(eager_ms - graph_ms) / T, differing=differing,
                leaves=len(dict(leaves(captured))))


def lane_draws(lane, state, key: torch.Tensor, T: int = T_UNROLL):
    """One unroll's draws, made as ``FastLane.unroll`` makes them from the
    state's per-env keys and the unroll's ``key``: (noise, eps,
    last_kick)."""
    eps = lane.draw_eps(key, state.qpos.shape[0], T)
    _, noise, last_kick = lane.draw_noise_block(state.info["rng"], T)
    return noise, eps, last_kick


def run(q: torch.Tensor, lane_case=None, iters: int = common.ITERS,
        runs: int = common.RUNS) -> Dict[str, dict]:
    """Every case: ``copy_q`` on the ``(19, B)`` block ``q`` (held against its
    plain version), the two torch bodies, and, when ``lane_case`` is given
    as (lane, state, params, noise, eps, last_kick), ``unroll_ab`` of it.
    Returns, per case, ``eager_us`` and ``graph_us`` per step (``copy_q``
    also ``max_abs_err``, ``differing``, ``plain_ms``, ``library_us``:
    ``torch.add(q, 1e-7, out=)`` eager and graphed, and ``one_thread_us``:
    the one-thread copy's), and ``unroll``."""
    B, dev = q.shape[1], q.device
    print(common.nvidia_smi(), flush=True)
    print(f"the loop around a launch, {iters} steps per window with the state carried, best "
          f"of {runs} windows (CUDA events), eager and from one CUDA graph:", flush=True)
    err, differing, plain_ms = common.check_copy("q", (q,))
    eager, graph = common.carried_us(lambda a, b: common.copy_probe("q", (a,), (b,)), (q,),
                                     iters, runs)
    library = common.carried_us(lambda a, b: torch.add(a, common.COPY_EPS, out=b), (q,),
                                iters, runs)
    one = common.carried_us(lambda a, b: common.copy_probe_one_thread("q", (a,), (b,)), (q,),
                            iters, runs)
    results = {"copy_q": dict(eager_us=eager, graph_us=graph, max_abs_err=err,
                              differing=differing, plain_ms=plain_ms, library_us=library,
                              one_thread_us=one, envs=B)}
    print(f"copy_q {tuple(q.shape)}: eager (pyloop) {eager:9.2f} us, graph (scan, unroll) "
          f"{graph:9.2f} us per step; vs plain: max abs err {err!r}, {differing} of {B} envs "
          f"differ; plain {plain_ms:.3f} ms; torch.add(q, 1e-7) eager {library[0]:9.2f} us, "
          f"graph {library[1]:9.2f} us; one-thread copy eager {one[0]:9.2f} us, graph "
          f"{one[1]:9.2f} us", flush=True)
    bodies = {
        "torch_add": (lambda a, b: torch.add(a, 1.0, out=b), SMALL_SHAPE),
        "torch_tanh_add": (lambda a, b: torch.add(torch.tanh(a), 1.0, out=b), (B, BIG_WIDTH)),
    }
    for name, (body, shape) in bodies.items():
        x = torch.zeros(shape, dtype=torch.float32, device=dev)
        eager, graph = common.carried_us(body, (x,), iters, runs)
        results[name] = dict(eager_us=eager, graph_us=graph, shape=shape)
        print(f"{name:14s} {str(shape):12s}: eager {eager:9.2f} us, graph {graph:9.2f} us per "
              f"step", flush=True)
    if lane_case is not None:
        ab = results["unroll"] = unroll_ab(*lane_case, runs=runs)
        print(f"K3 lane (team K3) unroll T={ab['T']} x {ab['envs']} envs: eager {ab['eager_ms']:.3f} ms, "
              f"one CUDA graph {ab['graph_ms']:.3f} ms per unroll; host time per step "
              f"(eager - graph) / T {ab['host_ms_per_step']:.4f} ms; the graph's {ab['leaves']} "
              f"output tensors equal the eager ones bit for bit", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    common.require_cuda("profile_scan")
    from puppax_torch import random
    from puppax_torch.configs import EnvConfig, TrainConfig
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.train import networks, running_statistics

    device = torch.device("cuda", 0)
    smi = common.nvidia_smi()
    print(smi, flush=True)
    env, tc = PupperV3Env.from_config(EnvConfig(), device=device), TrainConfig()
    build.build_in_parallel(build.probe_copy_library, lambda: build.wrapped_step_team_library(
        env._s, env._es, env._n_substeps, tc.episode_length))
    common.print_builds([build.record_name(build.PROBE_COPY),
                         build.record_name(build.WRAPPED_STEP_TEAM)])
    key_net, key_env, key_run = random.split(random.key(args.seed, device), 3).unbind(0)
    wrapped = wrap_for_training(env, tc.episode_length)  # the nominal model
    lane = FastLane(wrapped)
    policy = networks.make_ppo_networks(
        env.observation_size, env.action_size, tc.policy_hidden_layer_sizes,
        tc.value_hidden_layer_sizes, tc.activation, device=device, key=key_net).policy_network
    params = (running_statistics.init_state(env.observation_size, device=device), policy)
    state = wrapped.reset(random.split(key_env, args.envs))
    q = common.nominal_blocks(env._s, env.model, args.envs, device)[0]
    run(q, (lane, state, params, *lane_draws(lane, state, key_run)))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
