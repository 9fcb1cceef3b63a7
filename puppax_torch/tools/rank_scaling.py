"""One training configuration as one process and as N ranks, compared.

    python -m puppax_torch.tools.rank_scaling --nproc 4 [--config cfg.json]
        [--set train.num_timesteps=491520 ...] [--device cpu]

On the card it first builds the configuration's team K3 and team K2
bodies once (in parallel processes, into ``build/``), so that every rank
loads them from there, then runs the training CLI twice with the same
arguments and seed, each with a checkpoint directory and a metrics JSONL
of its own in a temporary directory:

1. one process on one card: ``python -m puppax_torch.scripts.train``;
2. N ranks, one per card: ``python -m torch.distributed.run --standalone
   --nproc_per_node N -m puppax_torch.scripts.train`` (NCCL).

For each run it prints the lane line, its wall seconds, and from the last
training record of its JSONL ``training/sps`` and the rollout, reorder +
normalizer and SGD ms per training step (every process renders the
bodies again to find them in ``build/``, team K3's inside its first
epoch: with ``train.num_evals`` 3 or more the last epoch is free of it);
then, for the policy's and the value net's weights and the normalizer's
mean and std, the largest absolute difference between the two runs'
final values, alone and over the largest element (the ranks' sums reduce
in another order, the products run at another batch size, and the
rollouts' contacts grow that), and the cards' ``nvidia-smi`` name and
power limit. With
``--device cpu`` the ranks are gloo processes on the CPU and nothing is
built. It exits 1 with "no CUDA device found" without a card otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _last_training(jsonl: str) -> dict:
    records = [json.loads(x) for x in open(jsonl)]
    return [r for r in records if "training/sps" in r][-1]


def _build_bodies(argv) -> None:
    """The configuration's team K3 (the rollout) and team K2 (the
    evaluator), built once for every process after it."""
    from puppax_torch.configs import experiment as exp
    from puppax_torch.configs import get_config
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.kernels import build

    cfg = exp.ExperimentConfig()
    if argv.config:
        with open(argv.config) as f:
            cfg = exp.from_dict(json.load(f))
    if argv.set:
        cfg = exp.apply_overrides(cfg, dict(exp.parse_override(s) for s in argv.set))
    env = PupperV3Env.from_config(cfg.env, reward_config=get_config(), device="cuda")
    s, es, n = env._s, env._es, env._n_substeps
    t0 = time.perf_counter()
    build.build_batch((build.wrapped_step_team_library, (s, es, n, cfg.train.episode_length)),
                      (build.env_step_team_library, (s, es, n)))
    print(f"built team K3 and team K2 in {time.perf_counter() - t0:.1f} s", flush=True)


def _run(label: str, cmd, env) -> float:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write((proc.stdout + proc.stderr)[-6000:])
        raise SystemExit(f"{label} exited {proc.returncode}")
    for line in proc.stdout.splitlines():
        if line.startswith("[puppax.ppo]"):
            print(f"{label}: {line}", flush=True)
    return wall


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4, help="ranks of the second run")
    ap.add_argument("--config", default=None, help="JSON config file")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--device", default="cuda", help="cuda (one card a rank) or cpu (gloo)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("rank_scaling: no CUDA device found", file=sys.stderr)
        raise SystemExit(1)
    if not cpu and torch.cuda.device_count() < args.nproc:
        raise SystemExit(f"{args.nproc} ranks need {args.nproc} cards, "
                         f"{torch.cuda.device_count()} visible")
    if not cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        _build_bodies(args)

    from puppax_torch.train import checkpoint

    tmp = tempfile.mkdtemp(prefix="puppax_torch_ranks_")
    base = (["--config", os.path.abspath(args.config)] if args.config else []) + [
        "--device", args.device]
    for s in args.set:
        base += ["--set", s]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    runs = {}
    for name, launcher in (("one process", []),
                           (f"{args.nproc} ranks", ["-m", "torch.distributed.run", "--standalone",
                                                     "--nproc_per_node", str(args.nproc)])):
        d = os.path.join(tmp, name.replace(" ", "_"))
        cmd = [sys.executable, *launcher, "-m", "puppax_torch.scripts.train", *base,
               "--set", f"train.checkpoint_path={json.dumps(os.path.join(d, 'ckpt'))}",
               "--set", f"train.metrics_jsonl={json.dumps(os.path.join(d, 'metrics.jsonl'))}"]
        wall = _run(name, cmd, env)
        last = _last_training(os.path.join(d, "metrics.jsonl"))
        runs[name] = (checkpoint.restore_checkpoint(os.path.join(d, "ckpt", "state")), last)
        print(f"{name}: wall {wall:.1f} s; training/sps {last['training/sps']:.1f}; per training "
              f"step rollout {last['training/rollout_ms']:.3f} ms, reorder + normalizer "
              f"{last['training/prepare_ms']:.3f} ms, SGD {last['training/sgd_ms']:.3f} ms; "
              f"training/total_loss {last['training/total_loss']!r}; eval/episode_reward "
              f"{last.get('eval/episode_reward', float('nan'))!r}", flush=True)
    (one, one_last), (many, many_last) = runs.values()
    worst = {}
    for part in ("policy", "value", "normalizer"):
        diffs = [((many["params"][part][k].double() - want.double()).abs(), want.double().abs())
                 for k, want in one["params"][part].items()
                 if part != "normalizer" or k in ("mean", "std")]
        worst[part] = (max(float(d.max()) for d, _ in diffs),
                       max(float(d.max()) / max(float(w.max()), 1e-30) for d, w in diffs))
        print(f"final {part} ({'mean, std' if part == 'normalizer' else 'weights, biases'}), "
              f"{args.nproc} ranks against one process: largest absolute difference "
              f"{worst[part][0]:.3g}, {worst[part][1]:.3g} of the largest element", flush=True)
    print(f"env steps {many['env_steps']} / {one['env_steps']}; training/sps {args.nproc} ranks "
          f"/ one process {many_last['training/sps'] / one_last['training/sps']:.3f}", flush=True)
    print(json.dumps({"nproc": args.nproc, "sps": [one_last["training/sps"],
                                                   many_last["training/sps"]],
                      "max_abs_diff": max(a for a, _ in worst.values())}))


if __name__ == "__main__":
    main()
