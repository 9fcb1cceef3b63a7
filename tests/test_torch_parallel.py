"""Multi-GPU training's distribution layer (``puppax_torch/parallel``) on the
CPU: two gloo ranks in subprocesses (``tests/torch_parallel_worker.py``,
started as ``tests/test_distributed.py`` starts its workers, on a free
localhost port).

* The mesh functions in one process: a world of one without a process
  group, ``maybe_initialize_distributed`` False without an address, the
  ranks' row slices, ``shard_env_batch`` and the launcher's ``ValueError``
  for several devices in one process; and in two ranks joined through the
  launcher's variables: the mesh, the slices, one all-reduce and one
  all-gather.
* A sharded env step equals the unsharded one (``tests/test_parallel.py:40``'s
  counterpart): each rank resets its 4 of 8 envs from the world's keys and
  steps them 3 times; the ranks' rows equal one process's 8 envs (rtol
  1e-4 / atol 1e-5, ``test_parallel.py``'s; they agree bit for bit here).
* run12's configuration (DR, the privileged critic with its own normalizer,
  the curriculum, the gait clock) through the training CLI at a tiny size
  (4 envs, batch 2 x 2 minibatches, 2 training steps, 2 eval envs) on each
  lane (K3's, the physics-only lane on K1's plain version, the fused lane
  on K4's), as two ranks against one process: both ranks end with equal
  params, bit for bit (both apply the same all-reduced gradients); the
  weights and the normalizers equal the one-process run's within rtol 1e-5
  / atol 1e-6 (the ranks' sums reduce in another order: the normalizer's
  moments, the advantages' mean and spread, each loss's two parts, so the
  weights part by ~1e-7 after the first update; the second step's rollouts
  run under those weights, and a third step's contacts have grown that to
  ~1e-4 relative in a privileged row's normalizer: two steps keep the
  comparison at rounding); only
  rank 0 writes the
  checkpoints and the metrics JSONL, rank 0 alone prints the lane line,
  which names the rank, the world and the backend, and the collectives
  are the ones the run needs (one gradient all-reduce per minibatch, one
  batch all-gather per training step, the normalizers' moments).
* The same CLI under the launcher, ``python -m torch.distributed.run
  --standalone --nproc_per_node 2 -m puppax_torch.scripts.train --device
  cpu``, on K3's lane: one lane line, the JSONL's records those of the
  one-process run, and its checkpoint equal to that run's at the same
  tolerance; and ``python -m puppax_torch.tools.rank_scaling --device
  cpu``, which makes that comparison itself.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch import random
from puppax_torch.parallel import mesh as mesh_lib
from puppax_torch.scripts import train as train_cli
from puppax_torch.train import checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
RUN12 = os.path.join(ROOT, "dev", "run_configs", "run12_2b_cse.json")
TINY = {
    "train.num_timesteps": 16, "train.num_envs": 4, "train.episode_length": 4,
    "train.unroll_length": 2, "train.batch_size": 2, "train.num_minibatches": 2,
    "train.num_updates_per_batch": 1, "train.num_evals": 1, "train.num_eval_envs": 2,
    "train.curriculum_steps": 16, "env.environment_timestep": 0.004,
    "train.policy_hidden_layer_sizes": [32, 32], "train.value_hidden_layer_sizes": [32, 32],
}
LANES = {"k3": {}, "physics-only": {"PUPPAX_SOA_ENV": "off"},
         "fused": {"PUPPAX_FUSED_UNROLL": "on"}}
RTOL, ATOL = 1e-5, 1e-6
_GROUP_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
               "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra=None):
    env = {k: v for k, v in os.environ.items() if k not in _GROUP_VARS}
    env.update(extra or {})
    return env


def _start_workers(tmp_path, mode, argv=(), extra_env=None):
    address = f"localhost:{_free_port()}"
    return [subprocess.Popen([sys.executable, WORKER, mode, str(r), "2", address, str(tmp_path),
                              *argv], env=_env(extra_env), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, cwd=ROOT)
            for r in range(2)]


def _finish(procs, tmp_path):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)], outs


def _argv(over):
    argv = ["--config", RUN12, "--device", "cpu"]
    for k, v in over.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    return argv


def _assert_trees(got, want, exact):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees(got[k], want[k], exact)
    elif exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_mesh_in_one_process(monkeypatch):
    for name in _GROUP_VARS:
        monkeypatch.delenv(name, raising=False)
    assert mesh_lib.maybe_initialize_distributed(device="cpu") is False
    mesh = mesh_lib.make_env_mesh(["cpu"])
    assert (mesh.world, mesh.rank, mesh.backend, mesh.axis_name) == (1, 0, None, "env")
    assert mesh.is_lead
    assert mesh_lib.env_sharding(mesh, 8) == slice(0, 8)
    assert mesh_lib.replicated_sharding(mesh) == slice(None)
    x = torch.arange(4.0)
    assert mesh_lib.all_reduce_(x, mesh, "test") is x
    assert torch.equal(mesh_lib.all_gather(x, mesh, "test"), x[None])
    two = mesh_lib.EnvMesh(2, 1, torch.device("cpu"))
    assert mesh_lib.env_sharding(two, 8) == slice(4, 8) and not two.is_lead
    with pytest.raises(ValueError, match="do not split over 2 ranks"):
        mesh_lib.env_sharding(two, 7)
    tree = {"a": torch.arange(8), "b": (torch.zeros(8, 3), 5), "c": torch.tensor(1.0)}
    got = mesh_lib.shard_env_batch(tree, two)
    assert torch.equal(got["a"], torch.arange(4, 8)) and got["b"][0].shape == (4, 3)
    assert got["b"][1] == 5 and torch.equal(got["c"], tree["c"])
    state = H.torch_env().reset(random.split(random.key(7), 8))
    half = mesh_lib.shard_env_batch(state, two)
    assert torch.equal(half.qpos, state.qpos[4:]) and torch.equal(half.info["rng"],
                                                                  state.info["rng"][4:])
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node N"):
        mesh_lib.make_env_mesh(["cpu", "cpu"])


def test_mesh_two_ranks(tmp_path):
    (r0, r1), _ = _finish(_start_workers(tmp_path, "mesh"), tmp_path)
    for r, got in enumerate((r0, r1)):
        assert got["mesh"] == (2, r, "cpu", "gloo", "env")
        assert got["rows"] == slice(4 * r, 4 * r + 4)
        assert torch.equal(got["sharded"]["a"], torch.arange(4.0 * r, 4.0 * r + 4))
        assert torch.equal(got["sharded"]["b"][0], torch.arange(16).reshape(8, 2)[4 * r:4 * r + 4])
        assert torch.equal(got["sharded"]["c"], torch.tensor(3.0))
        assert torch.equal(got["psum"], torch.full((3,), 3.0))
        assert torch.equal(got["gathered"], torch.tensor([[0, 10], [1, 11]]))
        assert got["calls"] == {"test": 2}


def test_sharded_env_step_matches_unsharded(tmp_path):
    procs = _start_workers(tmp_path, "step")
    env = H.torch_env()
    actions = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (3, 8, 12))
                               .astype(np.float32))
    state = env.reset(random.split(random.key(7), 8))
    want = []
    for t in range(3):
        state = env.step(state, actions[t])
        want.append((state.obs, state.reward))
    (r0, r1), _ = _finish(procs, tmp_path)
    for t, (obs, reward) in enumerate(want):
        got_obs = torch.cat([r0["traj"][t][0], r1["traj"][t][0]])
        got_reward = torch.cat([r0["traj"][t][1], r1["traj"][t][1]])
        np.testing.assert_allclose(got_obs.numpy(), obs.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_reward.numpy(), reward.numpy(), rtol=1e-4, atol=1e-5)


def _one_process_run(tmp_path, monkeypatch, lane_env, capsys):
    for k, v in lane_env.items():
        monkeypatch.setenv(k, v)
    single = dict(TINY, **{"train.checkpoint_path": str(tmp_path / "one" / "ckpt"),
                           "train.metrics_jsonl": str(tmp_path / "one" / "metrics.jsonl")})
    metrics = train_cli.main(_argv(single))
    out = capsys.readouterr().out
    return metrics, out


@pytest.mark.parametrize("lane", list(LANES))
def test_two_rank_training_equals_one_process(tmp_path, monkeypatch, capsys, lane):
    over = dict(TINY, **{"train.checkpoint_path": str(tmp_path / "two" / "ckpt"),
                         "train.metrics_jsonl": str(tmp_path / "two" / "metrics.jsonl")})
    procs = _start_workers(tmp_path, "cli", _argv(over), LANES[lane])
    for name in _GROUP_VARS:
        monkeypatch.delenv(name, raising=False)
    metrics, out = _one_process_run(tmp_path, monkeypatch, LANES[lane], capsys)
    (r0, r1), (out0, out1) = _finish(procs, tmp_path)

    # both ranks apply the same all-reduced gradients
    _assert_trees(r1["params"], r0["params"], exact=True)
    one = checkpoint.restore_checkpoint(tmp_path / "one" / "ckpt" / "state")
    two = checkpoint.restore_checkpoint(tmp_path / "two" / "ckpt" / "state")
    _assert_trees(r0["params"], one["params"], exact=False)
    _assert_trees(two["params"], one["params"], exact=False)
    assert two["env_steps"] == one["env_steps"] == 16
    assert two["optimizer"]["count"] == one["optimizer"]["count"] == 4
    # the critic normalizer counts the world's inputs
    assert float(two["critic_normalizer"]["count"]) == float(one["critic_normalizer"]["count"])
    _assert_trees(two["critic_normalizer"], one["critic_normalizer"], exact=False)
    for k in ("training/total_loss", "training/policy_loss", "training/value_loss",
              "training/entropy_loss", "eval/episode_reward", "eval/avg_episode_length"):
        assert r0["metrics"][k] == r1["metrics"][k], k
        np.testing.assert_allclose(r0["metrics"][k], metrics[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)

    # one writer
    assert r1["saves"] == [] and len(r0["saves"]) == 3  # params, state, final params
    assert sorted(r0["saves"]) == sorted(
        (step, str(tmp_path / "two" / "ckpt" / sub)) for step, sub in
        ((16, ""), (16, "state"), (16, "")))
    lines = [json.loads(x) for x in open(tmp_path / "two" / "metrics.jsonl")]
    want = [json.loads(x) for x in open(tmp_path / "one" / "metrics.jsonl")]
    assert [sorted(x) for x in lines] == [sorted(x) for x in want]
    ranks = {"k3": "ON (ok; devices=2, rank 0 of 2, backend gloo, fused-unroll=OFF)",
             "physics-only": "OFF (PUPPAX_SOA_ENV=off; devices=2, rank 0 of 2, backend gloo)",
             "fused": "ON (ok; devices=2, rank 0 of 2, backend gloo, fused-unroll=ON)"}[lane]
    assert f"rollout fast lane: {ranks}" in out0
    assert "rollout fast lane" not in out1
    assert "devices=1" in out and "rank 0" not in out

    # the collectives: a gradient all-reduce per minibatch (2 training steps
    # x 1 update x 2 minibatches), a batch all-gather per training step,
    # 2 moments x 2 normalizers per training step, 2 advantage reductions
    # per minibatch, one metrics all-reduce per epoch, one eval all-gather
    assert r0["calls"] == r1["calls"] == {"grads": 4, "batch": 2, "normalizer": 8,
                                          "advantages": 8, "metrics": 1, "eval": 1}


def test_launcher_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    over = dict(TINY, **{"train.checkpoint_path": str(tmp_path / "two" / "ckpt"),
                         "train.metrics_jsonl": str(tmp_path / "two" / "metrics.jsonl")})
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "puppax_torch.scripts.train", *_argv(over)]
    proc = subprocess.Popen(cmd, env=_env({"OMP_NUM_THREADS": "1"}), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name in _GROUP_VARS:
        monkeypatch.delenv(name, raising=False)
    _one_process_run(tmp_path, monkeypatch, {}, capsys)
    out, _ = proc.communicate(timeout=600)
    out = out.decode()
    assert proc.returncode == 0, out[-4000:]
    assert out.count("[puppax.ppo] rollout fast lane: ON (ok; devices=2, rank 0 of 2, "
                     "backend gloo, fused-unroll=OFF)") == 1
    assert out.count("rollout fast lane") == 1
    lines = [json.loads(x) for x in open(tmp_path / "two" / "metrics.jsonl")]
    want = [json.loads(x) for x in open(tmp_path / "one" / "metrics.jsonl")]
    assert [sorted(x) for x in lines] == [sorted(x) for x in want]
    one = checkpoint.restore_checkpoint(tmp_path / "one" / "ckpt" / "state")
    two = checkpoint.restore_checkpoint(tmp_path / "two" / "ckpt" / "state")
    _assert_trees(two["params"], one["params"], exact=False)
    assert checkpoint.latest_checkpoint_step(tmp_path / "two" / "ckpt") == 16


def test_rank_scaling_tool_on_the_cpu(capsys, monkeypatch):
    """``python -m puppax_torch.tools.rank_scaling --device cpu``: the same
    run as one process and as 2 gloo ranks under the launcher, compared."""
    from puppax_torch.tools import rank_scaling

    for name in _GROUP_VARS:
        monkeypatch.delenv(name, raising=False)
    argv = ["--nproc", "2", "--device", "cpu", "--config", RUN12]
    for k, v in TINY.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    rank_scaling.main(argv)
    out = capsys.readouterr().out
    assert "one process: [puppax.ppo] rollout fast lane: ON (ok; devices=1, fused-unroll=OFF)" in out
    assert ("2 ranks: [puppax.ppo] rollout fast lane: ON (ok; devices=2, rank 0 of 2, backend "
            "gloo, fused-unroll=OFF)") in out
    assert "env steps 16 / 16" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["nproc"] == 2 and len(last["sps"]) == 2
    assert last["max_abs_diff"] < 1e-5
