"""``python -m puppax_torch.scripts.train`` end to end on the CPU.

A tiny configuration (4 envs, 1 physics substep, episode 8, unroll 2,
policy and value (32, 32), 2 eval envs) trains through the CLI's
``main(argv)`` with ``--device cpu``: the fast lane's plain version in the
rollout, the standard lane's in the evaluator, the learner, the metrics
sink and both checkpoint kinds. A ``--resume`` run then continues from the
saved train state. With ``PUPPAX_SOA_ENV=off`` the same run trains through
the physics-only lane: the standard lane's unrolls (``generate_unroll``
around ``PupperV3Env._step_core`` and K1's plain version), said by the
lane line. Without ``--device cpu`` and without a card, the CLI refuses to
start. The first run also logs through ``--wandb`` to a stub ``wandb``
module (a live run: its ``log`` and ``log_model`` calls recorded) and
renders ``train.progress_plot``.
"""

import json
import math
import sys
import types

import pytest
import torch

from puppax.configs import experiment as jexp
from puppax_torch.scripts import train as cli
from puppax_torch.train import checkpoint

torch.set_num_threads(1)

TINY = {
    "train.num_timesteps": 8, "train.num_envs": 4, "train.episode_length": 8,
    "train.unroll_length": 2, "train.batch_size": 2, "train.num_minibatches": 2,
    "train.num_updates_per_batch": 1, "train.num_evals": 2, "train.num_eval_envs": 2,
    "env.environment_timestep": 0.004,
    "train.policy_hidden_layer_sizes": [32, 32], "train.value_hidden_layer_sizes": [32, 32],
}


def _argv(tmp_path, **extra):
    over = dict(TINY, **{"train.checkpoint_path": str(tmp_path / "ckpt"),
                         "train.metrics_jsonl": str(tmp_path / "metrics.jsonl")}, **extra)
    argv = ["--device", "cpu"]
    for k, v in over.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    return argv, over


def _stub_wandb():
    mod = types.ModuleType("wandb")
    mod.run, mod.calls = object(), []
    mod.log = lambda metrics, step=None: mod.calls.append(("log", step, dict(metrics)))
    mod.log_model = lambda path, name: mod.calls.append(("log_model", path, name))
    return mod


def test_train_then_resume(tmp_path, capsys, monkeypatch):
    wandb = _stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    plot = tmp_path / "progress.png"
    argv, over = _argv(tmp_path, **{"train.progress_plot": str(plot)})
    metrics = cli.main(argv + ["--wandb"])
    out = capsys.readouterr().out
    want_hash = jexp.config_hash(jexp.apply_overrides(jexp.ExperimentConfig(), over))
    assert f"config hash: {want_hash}" in out
    for k in ("training/total_loss", "training/policy_loss", "training/value_loss",
              "training/entropy_loss", "training/sps", "eval/episode_reward"):
        assert math.isfinite(metrics[k]), k
    assert 0 < metrics["eval/avg_episode_length"] <= 8
    state_dir = tmp_path / "ckpt" / "state"
    assert checkpoint.latest_checkpoint_step(state_dir) == 8
    assert (tmp_path / "ckpt" / "8" / checkpoint.FILE).exists()
    first = checkpoint.restore_checkpoint(state_dir)
    assert first["env_steps"] == 8 and first["optimizer"]["count"] == 2
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert records[0]["step"] == 0
    assert [r["step"] for r in records if "eval/episode_reward" in r] == [0, 8]
    assert any(r.get("artifact") == "checkpoint_state_8" for r in records)
    # W&B: a log call per JSONL record at its step, an upload per artifact line
    logs = [(step, m) for kind, step, m in wandb.calls if kind == "log"]
    assert [step for step, _ in logs] == [r["step"] for r in records if "step" in r]
    assert [m.get("eval/episode_reward") for _, m in logs] == [
        r.get("eval/episode_reward") for r in records if "step" in r]
    uploads = [(path, name) for kind, path, name in wandb.calls if kind == "log_model"]
    assert uploads == [(r["path"], r["artifact"]) for r in records if "artifact" in r]
    assert ("checkpoint_8" in {name for _, name in uploads}
            and plot.exists() and plot.stat().st_size > 0)

    # resume: one more epoch of ceil(16 / 8) = 2 training steps from step 8
    argv, _ = _argv(tmp_path, **{"train.num_timesteps": 16})
    cli.main(argv + ["--resume"])
    resumed = checkpoint.restore_checkpoint(state_dir)
    assert checkpoint.latest_checkpoint_step(state_dir) == 24
    assert resumed["env_steps"] == 24 and resumed["optimizer"]["count"] == 2 + 4
    changed = [not torch.equal(a, b) for a, b in zip(first["params"]["policy"].values(),
                                                      resumed["params"]["policy"].values())]
    assert any(changed)


def test_train_on_the_physics_only_lane(tmp_path, capsys, monkeypatch):
    """``PUPPAX_SOA_ENV=off``: the fast lane is off, training unrolls the
    standard lane, whose env steps through ``_step_core`` (never K2's
    plain version) and whose physics goes through ``make_batched_step``."""
    from puppax_torch.env import soa_env
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.physics import soa

    monkeypatch.setenv("PUPPAX_SOA_ENV", "off")
    monkeypatch.setattr(soa_env, "env_step", lambda *a: pytest.fail("K2 lane taken"))
    monkeypatch.setattr(soa_env, "wrapped_step", lambda *a: pytest.fail("K3 lane taken"))
    cores, physics = [0], [0]
    core, rows = PupperV3Env._step_core, soa.physics_step_rows

    def counted_core(self, *a, **k):
        cores[0] += 1
        return core(self, *a, **k)

    def counted_rows(*a, **k):
        physics[0] += 1
        return rows(*a, **k)

    monkeypatch.setattr(PupperV3Env, "_step_core", counted_core)
    monkeypatch.setattr(soa, "physics_step_rows", counted_rows)
    argv, _ = _argv(tmp_path)
    metrics = cli.main(argv)
    out = capsys.readouterr().out
    assert "[puppax.ppo] rollout fast lane: OFF (PUPPAX_SOA_ENV=off; devices=1)" in out
    for k in ("training/total_loss", "training/sps", "eval/episode_reward"):
        assert math.isfinite(metrics[k]), k
    # 1 training step of 1 unroll x 2 steps, and 2 evaluations of 8 steps
    assert cores[0] == physics[0] == 1 * 2 + 2 * 8
    assert checkpoint.restore_checkpoint(tmp_path / "ckpt" / "state")["env_steps"] == 8


def test_unknown_key_and_missing_card_refuse(monkeypatch):
    with pytest.raises(KeyError, match="unknown config key"):
        cli.main(["--device", "cpu", "--set", "train.nonexistent=1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--set", "train.num_envs=4"])
