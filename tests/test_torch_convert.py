"""The orbax-to-port checkpoint converter (``convert_orbax_checkpoint.py``
and ``puppax_torch.train.checkpoint.save_jax_params``) on the CPU.

A small JAX params tree, ``(normalizer, PPONetworkParams)`` as
``scripts/train.py`` saves it, is made from numpy-seeded weights at run12's
observation width (history 4 and the gait clock, 146), saved with
``puppax.train.checkpoint.save_checkpoint`` (orbax), converted by the
script's ``main`` and exported by the port's CLI (``python -m
puppax_torch.scripts.export_policy --observation-history 4
--gait-phase-observation``). The JSON file must equal JAX's
``puppax.export.convert_params`` on the orbax tree as a string, with a
plain critic and with a privileged critic (the value net 34 inputs wider,
which the export never reads). The converted tree is the one
``ppo.params_state_dict`` writes, every leaf equal to the orbax leaf
(kernels transposed). A JAX train state whose optimizer is not optax's
adam (here SGD with momentum) is refused with a message and writes
nothing; an adam train state converts and resumes
(``test_torch_resume_jax.py``).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.export import convert_params as j_convert
from puppax.train import checkpoint as jcheckpoint
from puppax.train import ppo as jppo
from puppax.train.networks import PPONetworkParams
from puppax.train.running_statistics import RunningStatisticsState as JNorm
from puppax_torch.scripts import export_policy
from puppax_torch.train import checkpoint, networks, ppo

torch.set_num_threads(1)

OBS, PRIV, ACT = 146, 34, 12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_checkpoint", os.path.join(ROOT, "convert_orbax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mlp(rng, sizes):
    return {"params": {f"hidden_{i}": {
        "kernel": jnp.asarray(rng.uniform(-1, 1, (a, b)).astype(np.float32)
                              * np.float32(np.sqrt(3.0 / a))),
        "bias": jnp.asarray((0.1 * rng.standard_normal(b)).astype(np.float32))}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}}


def _jax_params(seed, priv):
    rng = np.random.default_rng(seed)
    mean = (rng.standard_normal(OBS) * 2.0 + 0.25).astype(np.float32)
    std = rng.uniform(0.3, 2.5, OBS).astype(np.float32)
    norm = JNorm(count=jnp.float32(4096.0), mean=jnp.asarray(mean),
                 summed_variance=jnp.asarray(std**2 * 4096.0), std=jnp.asarray(std))
    nets = PPONetworkParams(policy=_mlp(rng, [OBS, 32, 16, 2 * ACT]),
                            value=_mlp(rng, [OBS + (PRIV if priv else 0), 32, 1]))
    return norm, nets


@pytest.mark.parametrize("priv", [False, True], ids=["plain-critic", "privileged-critic"])
def test_convert_then_export_equals_jax(tmp_path, capsys, priv):
    params = _jax_params(3 + priv, priv)
    orbax_dir, port_dir = tmp_path / "orbax", tmp_path / "port"
    jcheckpoint.save_checkpoint(200, params, orbax_dir)
    jcheckpoint.save_checkpoint(100, _jax_params(9, priv), orbax_dir)
    path = _converter().main(["--checkpoint", str(orbax_dir), "--out", str(port_dir)])
    out = capsys.readouterr().out
    assert path == str((port_dir / "200").resolve())
    assert f"value input width {OBS + PRIV * priv}" in out
    # the tree ppo.params_state_dict writes, leaf for leaf
    tree = checkpoint.restore_checkpoint(port_dir)
    assert set(tree) == {"normalizer", "policy", "value"}
    norm, nets = params
    for name in ("count", "mean", "summed_variance", "std"):
        assert np.array_equal(tree["normalizer"][name].numpy(), np.asarray(getattr(norm, name)))
    for net in ("policy", "value"):
        for layer, leaf in getattr(nets, net)["params"].items():
            assert np.array_equal(tree[net][f"{layer}.weight"].numpy(),
                                  np.asarray(leaf["kernel"]).T)
            assert np.array_equal(tree[net][f"{layer}.bias"].numpy(), np.asarray(leaf["bias"]))
    mlp = networks.make_ppo_networks(OBS, ACT, (32, 16), (32,), device="cpu",
                                     privileged_size=PRIV * priv)
    mlp.policy_network.load_state_dict(tree["policy"])
    mlp.value_network.load_state_dict(tree["value"])
    assert set(ppo.params_state_dict((norm, mlp.params))) == set(tree)

    json_path, jax_json = tmp_path / "policy.json", tmp_path / "jax_policy.json"
    flags = ["--observation-history", "4", "--gait-phase-observation"]
    export_policy.main(["--checkpoint", str(port_dir), "--out", str(json_path), "--device",
                        "cpu", *flags])
    # JAX's convert_params on the orbax tree (its weights as restored), and
    # JAX's export CLI on the orbax directory
    jenv = JaxEnv(path=None, reward_config=get_config(), action_scale=0.75,
                  observation_history=4)
    restored = jax.tree_util.tree_map(np.asarray, jcheckpoint.restore_checkpoint(
        orbax_dir, step=200))
    jnorm = JNorm(**restored[0])
    want = json.dumps(j_convert(
        (jnorm, restored[1]["policy"]), "elu", 0.75, 5.0, 0.25, np.asarray(jenv._default_pose),
        np.asarray(jenv.uppers), np.asarray(jenv.lowers), True, 4, 0.0, 0.0,
        gait_phase_observation=True, gait_frequency=2.5, control_dt=0.02))
    assert json_path.read_text() == want
    assert json.loads(want)["in_shape"] == [None, OBS]
    spec = importlib.util.spec_from_file_location(
        "jax_export_policy", os.path.join(ROOT, "scripts", "export_policy.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.argv", ["export_policy.py", "--checkpoint", str(orbax_dir), "--out",
                                str(jax_json), "--platform", "cpu", *flags])
        jcli.main()
    assert jax_json.read_text() == want


def test_train_state_checkpoint_is_refused(tmp_path):
    """A train state of another optimizer than optax's adam is refused: the
    port's ``ppo.Adam`` cannot take its state."""
    norm, nets = _jax_params(5, False)
    state = jppo.TrainingState(optimizer_state=optax.sgd(1e-3, momentum=0.9).init(nets),
                               params=nets, normalizer_params=norm,
                               env_steps=jppo.StepCount.zero())
    jcheckpoint.save_checkpoint(8, state, tmp_path / "ckpt" / "state")
    with pytest.raises(SystemExit, match="not optax's adam .* the port's Adam cannot take it"):
        _converter().main(["--checkpoint", str(tmp_path / "ckpt" / "state"), "--out",
                           str(tmp_path / "port")])
    assert checkpoint.latest_checkpoint_step(tmp_path / "port" / "state") is None
    with pytest.raises(SystemExit, match="no checkpoints"):
        _converter().main(["--checkpoint", str(tmp_path / "none"), "--out",
                           str(tmp_path / "port")])
