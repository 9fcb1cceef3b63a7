"""``chip_smoke.py``'s rank checks on the CPU, under gloo instead of NCCL.

* ``one_rank_update_check``: one minibatch update through the learner's
  rank path (the normalizer's reduced update, the batch's all-gather, the
  advantages' reductions, the gradients' all-reduce) under a one-rank
  process group must equal the single-process update bit for bit on the
  same data and keys; the group's collectives are counted; the
  single-process update runs under ``profiling.trace`` (host only here).
* ``launched_cli``: the child the smoke starts under ``python -m
  torch.distributed.run --standalone --nproc_per_node 1``, run12's
  configuration through the training CLI at a tiny size with ``--device
  cpu``; its record names the group's backend, rank and world and the
  learner's collectives, and the run trains as the CLI does in one process
  (the curriculum's difficulties, the env steps).
"""

import importlib.util
import json
import os
import subprocess
import sys

import torch

import torch_port_helpers as H
from puppax_torch import random
from puppax_torch.configs import TrainConfig
from puppax_torch.env import rollout, wrappers
from puppax_torch.train import networks, running_statistics

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")
RUN12 = os.path.join(REPO, "dev", "run_configs", "run12_2b_cse.json")


def _smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_one_rank_update_check_on_the_cpu(monkeypatch, capsys, tmp_path):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    mod = _smoke_module()
    monkeypatch.setattr(mod, "T_UNROLL", 2)
    env = H.torch_env()
    wrapped = wrappers.wrap_for_training(env, episode_length=50)
    lane = rollout.FastLane(wrapped)
    tc = TrainConfig(batch_size=4, policy_hidden_layer_sizes=(32, 32),
                     value_hidden_layer_sizes=(32, 32))
    nets = networks.make_ppo_networks(env.observation_size, env.action_size, (32, 32),
                                      (32, 32), device="cpu")
    state = wrapped.reset(random.split(random.key(1), 8))
    norm = running_statistics.update(running_statistics.init_state(env.observation_size, "cpu"),
                                     state.obs)
    got = mod.one_rank_update_check(lane, wrapped, (norm, nets.policy_network),
                                    random.split(random.key(2), 8), random.key(3),
                                    random.key(4), tc, torch.device("cpu"),
                                    trace_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "one minibatch update (2 x 4 transitions, single process) trace: 0 device " in out
    assert got["trace"]["launches"] == {} and got["trace"]["idle"] == 1.0
    (trace_file,) = os.listdir(tmp_path)
    assert trace_file.startswith("minibatch_update.") and trace_file.endswith(".pt.trace.json")
    assert "one-rank gloo group (world 1, backend gloo)" in out
    assert "0 of " in out and "max abs err 0.0" in out
    assert got["calls"] == {"normalizer": 2, "batch": 1, "advantages": 2, "grads": 1}
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_launched_cli_child_on_the_cpu(tmp_path):
    over = {"train.num_timesteps": 16, "train.num_envs": 4, "train.episode_length": 4,
            "train.unroll_length": 2, "train.batch_size": 2, "train.num_minibatches": 2,
            "train.num_updates_per_batch": 1, "train.num_evals": 1, "train.num_eval_envs": 2,
            "train.curriculum_steps": 16, "env.environment_timestep": 0.004,
            "train.policy_hidden_layer_sizes": [32, 32],
            "train.value_hidden_layer_sizes": [32, 32],
            "train.checkpoint_path": str(tmp_path / "ckpt"),
            "train.metrics_jsonl": str(tmp_path / "metrics.jsonl")}
    argv = ["--config", RUN12, "--device", "cpu"]
    for k, v in over.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    spec, result = tmp_path / "spec.json", tmp_path / "rank0.json"
    spec.write_text(json.dumps({"argv": argv, "B": 4, "run12": True, "out": str(result)}))
    child = tmp_path / "child.py"
    child.write_text(
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {SMOKE!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "mod.launched_cli(sys.argv[1])\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", str(child), str(spec)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert ("rollout fast lane: ON (ok; devices=1, rank 0 of 1, backend gloo, "
            "fused-unroll=OFF)") in proc.stdout
    rec = json.loads(result.read_text())
    assert (rec["group"]["backend"], rec["group"]["rank"], rec["group"]["world"]) == ("gloo", 0, 1)
    assert rec["group"]["init_seconds"] > 0
    assert rec["calls"] == {"grads": 4, "batch": 2, "normalizer": 8, "advantages": 8,
                            "metrics": 1, "eval": 1}
    assert rec["seen"] == [0.0, 0.5]
    # the plain versions on CPU tensors count no launch
    assert rec["launches"] == [0, 0, 0, 0] and rec["one_thread"] == [0, 0, 0, 0]
    assert rec["by_body"] == []
    assert rec["metrics"]["training/total_loss"] == rec["metrics"]["training/total_loss"]
    assert sorted(os.listdir(tmp_path / "ckpt" / "state")) == ["16"]
