"""The port's policy export (``puppax_torch/export``, the CLI
``python -m puppax_torch.scripts.export_policy``) against the JAX package's
(``puppax/export``) on the same weights.

Weights are drawn with numpy from a seed and carried into both packages
(``networks.params_from_jax`` and ``running_statistics.from_jax``; for a
torch-initialised MLP the reverse, ``(out, in)`` -> a flax tree), at policy
widths (32, 16) and the default 4 x 128:

- ``fold_in_normalization`` bit for bit with JAX's;
- ``json.dumps`` of ``convert_params`` equal, as a string, to JAX's, with
  and without the gait keys, for elu and tanh;
- ``apply_exported_policy`` equal to JAX's, and the exported forward
  against the port's deterministic policy at ``tests/test_export.py``'s
  tolerance;
- the port's ``NativePolicy`` (g++ into a temporary build root) against the
  port's replay (rtol 1e-5, atol 1e-6, ``tests/test_native_runtime.py``'s)
  and, output for output, against JAX's ``NativePolicy`` on the same JSON,
  the gait clock's ticks included; on a fold made ill-conditioned by a
  std at its floor, against ``native.runtime_forward`` (the runtime's
  float32 arithmetic) in place of the float64 replay;
- the CLI end to end on temporary checkpoints with ``--device cpu``.

JAX's ``NativePolicy`` is given the library the port built (with
``native/Makefile``'s flags): its own ``build_native_runtime`` runs
``make`` in ``native/``, which ``tests/test_native_runtime.py`` may be
doing at the same time in another worker.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puppax.export import apply_exported_policy as j_apply
from puppax.export import convert_params as j_convert
from puppax.export import fold_in_normalization as j_fold
from puppax.export.native import NativePolicy as JNativePolicy
from puppax.train.running_statistics import RunningStatisticsState as JNorm
from puppax_torch import random
from puppax_torch.export import apply_exported_policy, convert_params, fold_in_normalization
from puppax_torch.export import native
from puppax_torch.scripts import export_policy as cli
from puppax_torch.train import checkpoint, networks, ppo, running_statistics
from puppax_torch.train.distribution import NormalTanhDistribution

torch.set_num_threads(1)

OBS, ACT = 72, 12
WIDTHS = [(32, 16), (128, 128, 128, 128)]
ABI = dict(action_scale=0.75, kp=5.0, kd=0.25, default_pose=np.zeros(12),
           joint_upper_limits=np.ones(12), joint_lower_limits=-np.ones(12), use_imu=True,
           observation_history=2, maximum_pitch_command=30.0, maximum_roll_command=30.0)
GAIT = dict(gait_phase_observation=True, gait_frequency=2.5, control_dt=0.02)


def _weights(seed, obs=OBS, hidden=(32, 16)):
    """A numpy-seeded policy: [(kernel (in, out), bias)] float32, and the
    normalizer's (mean, std)."""
    rng = np.random.default_rng(seed)
    sizes = [obs, *hidden, 2 * ACT]
    layers = [(rng.uniform(-1, 1, (i, o)).astype(np.float32) * np.float32(np.sqrt(3.0 / i)),
               (0.1 * rng.standard_normal(o)).astype(np.float32))
              for i, o in zip(sizes[:-1], sizes[1:])]
    mean = (rng.standard_normal(obs) * 2.0 + 0.25).astype(np.float32)
    std = rng.uniform(0.3, 2.5, obs).astype(np.float32)
    return layers, mean, std


def _jax_params(layers, mean, std):
    tree = {"params": {f"hidden_{i}": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
                       for i, (k, b) in enumerate(layers)}}
    norm = JNorm(count=jnp.float32(1.0), mean=jnp.asarray(mean),
                 summed_variance=jnp.zeros_like(jnp.asarray(mean)), std=jnp.asarray(std))
    return norm, tree


def _torch_params(layers, mean, std, activation="elu"):
    hidden = tuple(k.shape[1] for k, _ in layers)
    mlp = networks.MLP(layers[0][0].shape[0], hidden, activation, device="cpu")
    flax = {f"hidden_{i}": {"kernel": k, "bias": b} for i, (k, b) in enumerate(layers)}
    mlp.load_state_dict(networks.params_from_jax(flax))
    return running_statistics.from_jax(mean, std, count=1.0), mlp


def _flax_from_torch(mlp):
    """A torch MLP's layers as the flax tree's (in, out) kernels."""
    return [(l.weight.detach().numpy().T, l.bias.detach().numpy()) for l in mlp.layers()]


def test_fold_in_normalization_bit_for_bit():
    layers, mean, std = _weights(0)
    k, b = layers[0]
    got = fold_in_normalization(k, b, mean, std)
    want = j_fold(jnp.asarray(k), jnp.asarray(b), jnp.asarray(mean), jnp.asarray(std))
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


@pytest.mark.parametrize("gait", [False, True], ids=["clock-off", "clock-on"])
@pytest.mark.parametrize("hidden", WIDTHS, ids=["32x16", "4x128"])
@pytest.mark.parametrize("activation", ["elu", "tanh"])
def test_convert_params_json_equals_jax(activation, hidden, gait):
    obs = OBS + 2 if gait else OBS
    layers, mean, std = _weights(1, obs, hidden)
    extra = GAIT if gait else {}
    want = json.dumps(j_convert(_jax_params(layers, mean, std), activation, **ABI, **extra))
    got = json.dumps(convert_params(_torch_params(layers, mean, std, activation), activation,
                                    **ABI, **extra))
    assert got == want
    # the state dict and the checkpoint's normalizer dict give the same JSON
    norm, mlp = _torch_params(layers, mean, std, activation)
    as_dicts = ({"mean": norm.mean, "std": norm.std}, mlp.state_dict())
    assert json.dumps(convert_params(as_dicts, activation, **ABI, **extra)) == want


@pytest.mark.parametrize("activation", ["elu", "tanh"])
def test_torch_initialised_policy_json_equals_jax(activation):
    """A policy the port initialised (its weights (out, in)) carried into a
    flax tree: the same JSON from both packages."""
    nets = networks.make_ppo_networks(OBS, ACT, (32, 16), (32,), activation, device="cpu",
                                      key=random.key(3))
    _, mean, std = _weights(2)
    norm = running_statistics.from_jax(mean, std)
    want = json.dumps(j_convert(_jax_params(_flax_from_torch(nets.policy_network), mean, std),
                                activation, **ABI))
    assert json.dumps(convert_params((norm, nets.policy_network), activation, **ABI)) == want


def test_layers_in_index_order():
    """Twelve layers: hidden_10 and hidden_11 come after hidden_9, not
    after hidden_1."""
    layers, mean, std = _weights(4, hidden=(8,) * 11)
    exported = convert_params(_torch_params(layers, mean, std), "elu", **ABI)
    assert [len(lay["weights"][1]) for lay in exported["layers"]] == [8] * 11 + [ACT]
    assert exported["layers"][5]["weights"][1] == layers[5][1].tolist()


@pytest.mark.parametrize("hidden", WIDTHS, ids=["32x16", "4x128"])
def test_apply_exported_policy_equals_jax(hidden):
    layers, mean, std = _weights(5, hidden=hidden)
    exported = convert_params(_torch_params(layers, mean, std), "elu", **ABI)
    obs = np.random.default_rng(6).standard_normal((16, OBS)).astype(np.float32)
    assert np.array_equal(apply_exported_policy(exported, obs), j_apply(exported, obs))


@pytest.mark.parametrize("activation", ["elu", "tanh"])
@pytest.mark.parametrize("hidden", WIDTHS, ids=["32x16", "4x128"])
def test_exported_forward_matches_port_policy(activation, hidden):
    """The JSON's float64 replay against the port's deterministic policy,
    tanh(loc) of the policy on normalized observations, at
    ``tests/test_export.py``'s tolerance (float32 against float64)."""
    layers, mean, std = _weights(7, hidden=hidden)
    norm, mlp = _torch_params(layers, mean, std, activation)
    exported = convert_params((norm, mlp), activation, **ABI)
    obs = (np.random.default_rng(8).standard_normal((32, OBS)) * 2.0).astype(np.float32)
    with torch.no_grad():
        want = NormalTanhDistribution(ACT).mode(
            mlp(running_statistics.normalize(torch.from_numpy(obs), norm))).numpy()
    np.testing.assert_allclose(apply_exported_policy(exported, obs), want, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    root = tmp_path_factory.mktemp("native_build")
    path = native.build_native_runtime(root)
    return root, path


def _write(tmp_path, exported, name="policy.json"):
    path = tmp_path / name
    path.write_text(json.dumps(exported))
    return str(path)


def test_native_build_is_cached_under_the_build_root(runtime):
    root, path = runtime
    assert path.startswith(str(root)) and path.endswith("libpuppax_policy.so")
    assert native.build_native_runtime(root) == path
    log = open(path.rsplit("/", 1)[0] + "/build.log").read()
    assert all(flag in log.splitlines()[0] for flag in native.CXX_FLAGS)


@pytest.mark.parametrize("hidden", WIDTHS, ids=["32x16", "4x128"])
def test_native_matches_replay_and_jax_native(runtime, tmp_path, hidden):
    _, lib = runtime
    layers, mean, std = _weights(9, hidden=hidden)
    exported = convert_params(_torch_params(layers, mean, std), "elu", **ABI)
    path = _write(tmp_path, exported)
    policy, jpolicy = native.NativePolicy(path, lib), JNativePolicy(path, lib)
    assert (policy.in_dim, policy.out_dim, policy.gait_enabled) == (OBS, ACT, False)
    rng = np.random.default_rng(10)
    for _ in range(20):
        obs = rng.standard_normal(OBS).astype(np.float32)
        out = policy(obs)
        np.testing.assert_allclose(out, apply_exported_policy(exported, obs), rtol=1e-5,
                                   atol=1e-6)
        assert np.array_equal(out, jpolicy(obs)) and np.all(np.abs(out) <= 1.0)
    with pytest.raises(ValueError):
        policy(np.zeros(OBS + 1, np.float32))
    policy.close()
    jpolicy.close()


def test_native_gait_clock_ticks(runtime, tmp_path):
    """A gait-clock policy (74 inputs): tick t of ``infer_clocked`` equals
    the replay with phase 2 pi f dt t mod 2 pi (use-then-advance), and JAX's
    ``NativePolicy`` tick for tick; ``reset_clock`` restarts the phase."""
    _, lib = runtime
    layers, mean, std = _weights(11, OBS + 2, (16,))
    exported = convert_params(_torch_params(layers, mean, std), "elu", **ABI, **GAIT)
    path = _write(tmp_path, exported)
    policy, jpolicy = native.NativePolicy(path, lib), JNativePolicy(path, lib)
    assert policy.in_dim == OBS + 2 and policy.gait_enabled and policy.gait_frequency == 2.5
    rng = np.random.default_rng(7)
    for repeat in range(2):
        policy.reset_clock()
        jpolicy.reset_clock()
        for t in range(8):
            hist = rng.standard_normal(OBS).astype(np.float32)
            out = policy.infer_clocked(hist)
            phase = (2.0 * np.pi * GAIT["gait_frequency"] * GAIT["control_dt"] * t) % (2.0 * np.pi)
            full = np.concatenate([hist, [np.cos(phase), np.sin(phase)]]).astype(np.float32)
            np.testing.assert_allclose(out, apply_exported_policy(exported, full), rtol=1e-5,
                                       atol=1e-6, err_msg=f"repeat {repeat} tick {t}")
            assert np.array_equal(out, jpolicy.infer_clocked(hist))
    policy.close()
    jpolicy.close()


@pytest.mark.parametrize("activation", ["elu", "tanh", "relu"])
def test_runtime_forward_is_the_native_arithmetic(runtime, tmp_path, activation):
    """A normalizer that saw constant observation columns (std at its 1e-6
    floor, as a trained policy's desired body z without pitch or roll
    commands): the fold multiplies those kernel rows by 1e6, in both
    packages alike (the same JSON, the same native outputs), and the
    runtime's float32 result parts from the float64 replay. It stays at
    tolerance with ``native.runtime_forward``, the runtime's arithmetic in
    numpy."""
    _, lib = runtime
    layers, mean, std = _weights(16, hidden=(128, 128))
    mean[9:12], std[9:12] = (0.0, 0.0, 1.0), 1e-6
    obs = (np.random.default_rng(17).standard_normal((32, OBS)) * 2.0).astype(np.float32)
    obs[:, 9:12] = mean[9:12]
    exported = convert_params(_torch_params(layers, mean, std, activation), activation, **ABI)
    assert json.dumps(exported) == json.dumps(j_convert(_jax_params(layers, mean, std),
                                                        activation, **ABI))
    path = _write(tmp_path, exported)
    policy, jpolicy = native.NativePolicy(path, lib), JNativePolicy(path, lib)
    got = np.stack([policy(o) for o in obs])
    assert np.array_equal(got, np.stack([jpolicy(o) for o in obs]))
    np.testing.assert_allclose(got, native.runtime_forward(exported, obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(native.runtime_forward(exported, obs[0]), got[0], rtol=1e-5,
                               atol=1e-6)
    assert np.abs(got - apply_exported_policy(exported, obs)).max() > 1e-5
    policy.close()
    jpolicy.close()


def test_native_rejects_garbage(runtime, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"layers": "nope"}')
    with pytest.raises(ValueError):
        native.NativePolicy(str(bad), runtime[1])


@pytest.fixture(scope="module")
def jax_env():
    from puppax.configs import get_config
    from puppax.env import PupperV3Env

    return PupperV3Env(path=None, reward_config=get_config(), action_scale=0.75,
                       observation_history=2)


def _save(ckpt, step, seed, obs=OBS, train_state=False):
    """A port checkpoint as the training CLI writes it (the params tree, or
    a train-state tree around it); returns its (normalizer, policy)."""
    nets = networks.make_ppo_networks(obs, ACT, (32, 16), (32,), "elu", device="cpu",
                                      key=random.key(seed))
    _, mean, std = _weights(seed, obs)
    norm = running_statistics.from_jax(mean, std, count=10.0)
    tree = ppo.params_state_dict((norm, nets.params))
    if train_state:
        tree = {"params": tree, "optimizer": {}, "env_steps": step}
    checkpoint.save_checkpoint(step, tree, ckpt)
    return norm, nets.policy_network


@pytest.mark.parametrize("train_state", [False, True], ids=["params-tree", "train-state"])
def test_cli_json_equals_jax(jax_env, tmp_path, capsys, train_state):
    """The latest of two checkpoints through the CLI: the JSON file equals
    JAX's ``convert_params`` on the same weights and the JAX CLI's env
    constants, as a string; ``--step`` picks the other."""
    ckpt = tmp_path / "ckpt"
    _save(ckpt, 50, 12, train_state=train_state)
    norm, policy = _save(ckpt, 100, 13, train_state=train_state)
    out = tmp_path / "policy.json"
    cli.main(["--checkpoint", str(ckpt), "--out", str(out), "--device", "cpu"])
    assert "wrote " in capsys.readouterr().out
    jparams = _jax_params(_flax_from_torch(policy), norm.mean.numpy(), norm.std.numpy())
    want = j_convert(jparams, "elu", 0.75, 5.0, 0.25, np.asarray(jax_env._default_pose),
                     np.asarray(jax_env.uppers), np.asarray(jax_env.lowers), True, 2, 0.0, 0.0,
                     gait_phase_observation=False, gait_frequency=2.5, control_dt=0.02)
    assert out.read_text() == json.dumps(want)
    cli.main(["--checkpoint", str(ckpt), "--step", "50", "--out", str(out), "--device", "cpu"])
    assert out.read_text() != json.dumps(want)


@pytest.mark.parametrize("obs,flag,hint", [
    (OBS + 2, False, "trained WITH the gait clock: pass --gait-phase-observation"),
    (OBS, True, "trained WITHOUT the gait clock: drop --gait-phase-observation"),
    (OBS + 8, False, "check --observation-history"),
], ids=["gait-checkpoint-no-flag", "flag-without-gait", "other-width"])
def test_cli_refuses_a_wrong_gait_flag(tmp_path, obs, flag, hint):
    _save(tmp_path / "ckpt", 1, 14, obs)
    argv = ["--checkpoint", str(tmp_path / "ckpt"), "--out", str(tmp_path / "p.json"),
            "--device", "cpu"] + (["--gait-phase-observation"] if flag else [])
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    expected = OBS + (2 if flag else 0)
    assert str(e.value) == f"checkpoint obs width {obs} != expected {expected} ({hint})"


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _save(tmp_path / "ckpt", 1, 15)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        cli.main(["--checkpoint", str(tmp_path / "ckpt"), "--out", str(tmp_path / "p.json")])
