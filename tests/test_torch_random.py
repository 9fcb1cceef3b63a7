"""The port's threefry (``puppax_torch/random.py``) against ``jax.random``,
and the port's key chains against the JAX package's, seed for seed.

Every function of ``random.py`` is held against ``jax.random`` (jax's
defaults: threefry2x32, the partitionable layout) over several seeds and
shapes, batched keys against ``jax.vmap``: bit for bit, but for
``normal``, whose erf_inv goes through another ``log1p`` (within 4 ulp).
The g++ build of ``csrc/threefry.cuh`` (the card's kernel, its per-pair
function on the CPU) is held against the plain version and jax's
``threefry_2x32``. Then the draws of the env (reset and step), DR, the
learner's key tree (``ppo.init_keys`` ... ``sgd_update_keys``, against
the ``jax.random`` calls of ``puppax/train/ppo.py`` in its order) and the
evaluator's chain (``puppax/train/acting.py:120-124, 164``) from the same
seeds; the fast lane's chains are in ``test_torch_rollout.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from jax._src import prng
from puppax.env import domain_randomization as jdr
from puppax_torch import random
from puppax_torch.configs import DomainRandomizationConfig
from puppax_torch.env.domain_randomization import domain_randomize
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.kernels import build
from puppax_torch.train import acting, ppo

torch.set_num_threads(1)

SEEDS = (0, 7, 123456789)


def _keys(seed, n):
    """(jax's keys, the port's) for ``split(PRNGKey(seed), n)``."""
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, random.from_key_data(np.asarray(jk))


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _assert_bits(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, -1, -12345])
def test_key_matches_prngkey(seed):
    _assert_bits(random.key(seed), jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_fold_in_and_bits(seed):
    jk, tk = jax.random.PRNGKey(seed), random.key(seed)
    for num in (2, 3, 6, 1000):
        _assert_bits(random.split(tk, num), jax.random.split(jk, num), f"split {num}")
    for data in (0, 1, 17, 2**32 - 1):
        _assert_bits(random.fold_in(tk, data), jax.random.fold_in(jk, data), f"fold_in {data}")
    for shape in ((), (5,), (4, 3), (2, 3, 7)):
        _assert_bits(random.random_bits(tk, shape), jax.random.bits(jk, shape), f"bits {shape}")
    # batched keys, as jax.vmap over them
    jks, tks = _keys(seed, 8)
    _assert_bits(random.split(tks, 5), jax.vmap(lambda k: jax.random.split(k, 5))(jks))
    _assert_bits(random.fold_in(tks, 9), jax.vmap(lambda k: jax.random.fold_in(k, 9))(jks))
    _assert_bits(random.random_bits(tks, (4, 3)),
                 jax.vmap(lambda k: jax.random.bits(k, (4, 3)))(jks))
    nested = random.from_key_data(np.asarray(jax.random.split(jks[0], 6)).reshape(2, 3, 2))
    _assert_bits(random.split(nested, 2).reshape(6, 2, 2),
                 jax.vmap(lambda k: jax.random.split(k, 2))(jax.random.split(jks[0], 6)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.6, 1.4), (-1.0, 1.0), (-np.pi, np.pi),
                                    ((-0.03, -0.01, -0.02), (0.03, 0.01, 0.02))])
def test_uniform_bit_for_bit(seed, bounds):
    """jax's uniform, its multiply-add rounded once (XLA contracts it):
    scalar and per-element bounds, one key and batched keys."""
    lo, hi = bounds
    shape = (3,) if np.ndim(lo) else (1000,)
    jk, tk = jax.random.PRNGKey(seed), random.key(seed)
    want = jax.random.uniform(jk, shape, minval=jnp.asarray(lo), maxval=jnp.asarray(hi))
    _assert_bits(random.uniform(tk, shape, lo, hi), want)
    jks, tks = _keys(seed, 64)
    want = jax.vmap(lambda k: jax.random.uniform(k, shape, minval=jnp.asarray(lo),
                                                 maxval=jnp.asarray(hi)))(jks)
    _assert_bits(random.uniform(tks, shape, lo, hi), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulp(seed):
    """XLA's erf_inv in the port (not ``torch.erfinv``): within 4 ulp of
    jax on 2^18 draws; the largest gap and the share that differ are
    printed."""
    jk, tk = jax.random.PRNGKey(seed), random.key(seed)
    got = random.normal(tk, (1 << 18,)).numpy()
    want = np.asarray(jax.random.normal(jk, (1 << 18,)))
    gap = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    print(f"normal, seed {seed}: largest gap {gap.max()} ulp, {np.mean(gap > 0):.4%} differ")
    assert gap.max() <= 4
    jks, tks = _keys(seed, 16)
    got = random.normal(tks, (20, 12)).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (20, 12)))(jks))
    gap = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert gap.max() <= 4


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_choice(seed):
    jks, tks = _keys(seed, 4096)
    for p in (0.02, 0.5):
        want = jax.vmap(lambda k: jax.random.bernoulli(k, p, (1,)))(jks)
        np.testing.assert_array_equal(random.bernoulli(tks, p, (1,)).numpy(), want)
    for p in ([0.2, 0.8], [0.5, 0.5], [0.1, 0.2, 0.3, 0.4]):
        pa = np.asarray(p, np.float32)
        want = jax.vmap(lambda k: jax.random.choice(k, len(p), p=jnp.asarray(pa)))(jks)
        np.testing.assert_array_equal(random.choice_p(tks, pa).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 10, 8192])
def test_permutation(seed, n):
    """Two rounds of sorts at the learner's 8192 rows, one below."""
    got = random.permutation(random.key(seed), n)
    np.testing.assert_array_equal(got.numpy(), jax.random.permutation(jax.random.PRNGKey(seed), n))


def test_fma_rounds_once():
    """``fma`` is ``a * b + c`` rounded once: against the exact sum in
    Python's fractions on values whose float64 sum lands on a float32
    midpoint (where a sum rounded twice parts), and at random."""
    from fractions import Fraction

    rng = np.random.RandomState(0)
    a = rng.uniform(-2, 2, 4096).astype(np.float32)
    b = rng.uniform(-2, 2, 4096).astype(np.float32)
    c = rng.uniform(-2, 2, 4096).astype(np.float32)
    # a float64 sum on a float32 midpoint: a * b = 2^16 - 2^-30, c = 2^40 +
    # 2^17 (odd), so the float64 sum is the midpoint 2^40 + 2^17 + 2^16 and
    # ties to the even 2^40 + 2^18, where the exact sum rounds to c; and
    # its mirror image
    a[:2] = np.float32(1 + 2.0**-23), np.float32(-(1 + 2.0**-23))
    b[:2] = np.float32(2.0**16 * (1 - 2.0**-23))
    c[:2] = np.float32(2.0**40 + 2.0**17), np.float32(-(2.0**40 + 2.0**17))
    got = random.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    exact = [Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
             for x, y, z in zip(a, b, c)]
    want = np.array([np.float32(float(v)) for v in exact])
    for i, v in enumerate(exact):  # round the exact value to float32 by hand where float() ties
        lo = np.float32(float(v))
        nb = np.nextafter(lo, np.float32(np.inf) if Fraction(float(lo)) < v else np.float32(-np.inf))
        if abs(Fraction(float(nb)) - v) < abs(Fraction(float(lo)) - v):
            want[i] = nb
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == c[0] and got[1] == c[1]


@pytest.fixture(scope="module")
def threefry_host(tmp_path_factory):
    return build.host_library(build.THREEFRY, "", tmp_path_factory.mktemp("threefry"))


def host_threefry(lib, keys: torch.Tensor, n: int, mode: int, offset: int = 0,
                  lo: torch.Tensor = None, hi: torch.Tensor = None) -> torch.Tensor:
    """``random.threefry`` through the g++ build of ``csrc/threefry.cuh``:
    the kernel's per-pair function on the CPU, the keys read in place."""
    out = torch.empty((keys.shape[0], n, 2) if mode == random.PAIRS else (keys.shape[0], n),
                      dtype=torch.int32 if mode in (random.PAIRS, random.BITS) else torch.float32)
    ptr = [None if t is None else t.data_ptr() for t in (lo, hi)]
    offset32 = offset - 2**32 if offset >= 2**31 else offset
    assert lib.threefry_host(keys.data_ptr(), ptr[0], ptr[1], out.data_ptr(), keys.shape[0], n,
                             offset32, mode, keys.stride(0)) == 0
    return out


def test_host_build_matches_plain_and_jax(threefry_host):
    """The kernel's per-pair function (g++) on 2^16 pairs: bit for bit with
    the plain ``threefry2x32`` in every mode but the normal, and with
    jax's ``threefry_2x32`` of the counters (0, i); the normal within 4
    ulp of the plain version (the C library's ``log1pf``)."""
    rng = np.random.RandomState(1)
    keys = random.from_key_data(rng.randint(0, 2**32, (64, 2), dtype=np.uint64).astype(np.uint32))
    n = 1024
    for mode in (random.PAIRS, random.BITS):
        got = host_threefry(threefry_host, keys, n, mode, offset=77)
        assert torch.equal(got, random.threefry_rows(keys, n, mode, offset=77)), mode
    lo = torch.from_numpy(rng.uniform(-3, 0, n).astype(np.float32))
    hi = torch.from_numpy(rng.uniform(0, 3, n).astype(np.float32))
    got = host_threefry(threefry_host, keys, n, random.UNIFORM, lo=lo, hi=hi)
    _assert_bits(got, random.threefry_rows(keys, n, random.UNIFORM, lo=lo, hi=hi).numpy())
    column = random.split(keys, 3)[:, 1]  # rows 6 ints apart, read in place
    assert column.stride(0) == 6
    got = host_threefry(threefry_host, column, n, random.BITS)
    assert torch.equal(got, random.threefry_rows(column.contiguous(), n, random.BITS))
    got = host_threefry(threefry_host, keys, n, random.NORMAL).numpy()
    want = random.threefry_rows(keys, n, random.NORMAL).numpy()
    assert np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32)).max() <= 4
    # jax's hash itself: threefry_2x32(key, [zeros, iota]) is (y0 ..., y1 ...)
    n = 1 << 16
    counts = np.concatenate([np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)])
    k = np.asarray(keys[3:4]).view(np.uint32)[0]
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(counts))).reshape(2, n).T
    got = host_threefry(threefry_host, keys[3:4], n, random.PAIRS)[0]
    _assert_bits(got, want)
    _assert_bits(random.threefry_rows(keys[3:4], n, random.PAIRS)[0], want)


def test_threefry_wrapper_routes_by_device():
    """CPU tensors run the plain version and count no launch; a tensor on
    another device raises; malformed keys and bounds raise."""
    keys = random.split(random.key(1), 3)
    before = random.threefry.launches
    got = random.threefry(keys, 4, random.BITS)
    assert torch.equal(got, random.threefry_rows(keys, 4, random.BITS))
    assert random.threefry.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        random.threefry(keys.to("meta"), 4, random.BITS)
    with pytest.raises(ValueError, match="int32"):
        random.threefry(keys.to(torch.int64), 4, random.BITS)
    with pytest.raises(ValueError, match="bounds"):
        random.threefry(keys, 4, random.UNIFORM)
    with pytest.raises(ValueError, match="32 bits"):
        random.threefry(keys, 4, random.BITS, offset=2**32 - 2)


# ---- the env, DR, the learner's key tree and the evaluator, seed for seed -----


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def env_runs():
    """The port's reset and 3 zero-action steps on B = 4 keys from
    ``split(PRNGKey(0), 4)`` beside ``jax.vmap(env.reset)`` and ``env.step``;
    each step's draws made from the state's keys on both sides."""
    jenv, tenv = H.jax_env(), H.torch_env()
    jkeys, tkeys = _keys(0, 4)
    jstate = jax.jit(jax.vmap(jenv.reset))(jkeys)
    tstate = tenv.reset(tkeys)
    jstep = jax.jit(jax.vmap(jenv.step))
    jdraw = jax.jit(jax.vmap(jenv._draw_step_noise))
    runs = [(_np(jstate), tstate, None, None)]
    zeros = jnp.zeros((4, 12))
    for _ in range(3):
        jnoise, tnoise = _np(jdraw(jstate.info["rng"])), tenv.draw_step_noise(tstate.info["rng"])
        jstate = jstep(jstate, zeros)
        tstate = tenv.step(tstate, torch.zeros(4, 12))
        runs.append((_np(jstate), tstate, jnoise, tnoise))
    return runs


def test_env_reset_and_steps_seed_for_seed(env_runs):
    """Keys, the command and every draw bit for bit (the resampled
    orientation, a rotation of two draws, within 2e-7); obs and reward at
    the suite's 2e-4, qpos 5e-5, qvel scaled 5e-4."""
    for t, (j, s, jnoise, tnoise) in enumerate(env_runs):
        _assert_bits(s.info["rng"], j.info["rng"], f"rng, step {t}")
        _assert_bits(s.info["command"], j.info["command"], f"command, step {t}")
        if jnoise is not None:
            for name in jnoise:
                want = jnoise[name] if name == "rng" else np.asarray(jnoise[name], np.float32)
                if name == "resample_ori":
                    # a rotation of the draws (ops/math.py), not a draw: XLA
                    # contracts its multiply-adds, so it parts by an ulp
                    np.testing.assert_allclose(tnoise[name].numpy(), want, atol=2e-7, rtol=0)
                else:
                    _assert_bits(tnoise[name], want, f"{name}, step {t}")
        np.testing.assert_allclose(s.obs.numpy(), j.obs, atol=2e-4, rtol=0, err_msg=f"obs {t}")
        np.testing.assert_allclose(s.reward.numpy(), j.reward, atol=2e-4, rtol=0)
        np.testing.assert_allclose(s.qpos.numpy(), j.pipeline_state.qpos, atol=5e-5, rtol=0)
        qv = j.pipeline_state.qvel
        np.testing.assert_allclose(s.qvel.numpy(), qv, rtol=0,
                                   atol=5e-4 * max(1.0, float(np.abs(qv).max())))
    # the reset's own draws: the start pose and the desired orientation
    j, s, _, _ = env_runs[0]
    _assert_bits(s.qpos[:, :3], j.pipeline_state.qpos[:, :3], "start xyz")
    np.testing.assert_allclose(s.info["desired_world_z_in_body_frame"].numpy(),
                               j.info["desired_world_z_in_body_frame"], atol=1e-7, rtol=0)


def test_seed0_golden_trace():
    """``tests/test_parallel.py::test_seed0_golden_trace``'s goldens from the
    port: the JAX package's env there (5 substeps) reset at PRNGKey(0) and
    stepped twice with zero actions, at that test's tolerances."""
    env = PupperV3Env(action_scale=0.75, observation_history=2, maximum_pitch_command=10.0,
                      maximum_roll_command=10.0, device="cpu")
    state = env.reset(random.key(0)[None])
    golden_obs0 = [-0.2374257892370224, -0.09360745549201965, -0.22135964035987854,
                   -0.049355585128068924, 0.043280232697725296, -0.9978429675102234,
                   -0.6137461066246033, 0.2516382932662964]
    np.testing.assert_allclose(state.obs[0, :8].numpy(), golden_obs0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(state.info["command"][0].numpy(),
                               [-0.6137461066246033, 0.2516382932662964, 1.806523323059082],
                               rtol=1e-5)
    for rew, obs_sum in zip([0.023049, 0.018086], [1.66894, 2.39034]):
        state = env.step(state, torch.zeros(1, 12))
        assert float(state.done[0]) == 0.0
        np.testing.assert_allclose(float(state.reward[0]), rew, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(float(state.obs[0].sum()), obs_sum, rtol=1e-3, atol=1e-5)


def test_domain_randomize_seed_for_seed():
    """``domain_randomize`` on B = 8 keys: every randomized leaf bit for bit
    with JAX's (the DR config's ranges, which are the JAX defaults)."""
    jkeys, tkeys = _keys(5, 8)
    jenv = H.jax_env()
    jmodel, _ = jdr.domain_randomize(jenv.model, jkeys)
    ranges = {k: v for k, v in vars(DomainRandomizationConfig()).items() if k != "enabled"}
    tmodel = domain_randomize(PupperV3Env(device="cpu", **H.env_kwargs()).model, tkeys, **ranges)
    for name in ("geom_friction", "actuator_gainprm", "actuator_biasprm", "body_ipos",
                 "body_inertia", "body_mass"):
        _assert_bits(getattr(tmodel, name), np.asarray(getattr(jmodel, name), np.float32), name)


@pytest.mark.parametrize("seed", [0, 7])
def test_ppo_key_tree_matches_jax(seed):
    """``ppo.train``'s key schedule against the ``jax.random`` calls of
    ``puppax/train/ppo.py``: the start (``:204-211``: key, network, env,
    eval, the DR keys; ``:621`` the reset keys), an epoch's split
    (``:747``), a training step's (``:504``), its unrolls' (``:480``) and
    two SGD passes (``:391, 411-414``), permutation included."""
    num_envs, n_unrolls, n_mb, total = 4, 3, 4, 8192
    got = ppo.init_keys(seed, num_envs, True, "cpu")
    key = jax.random.PRNGKey(seed)
    key, network_key, env_key, eval_key = jax.random.split(key, 4)
    key, key_dr = jax.random.split(key)
    _assert_bits(got["network"], network_key)
    _assert_bits(got["eval"], eval_key)
    _assert_bits(got["dr"], jax.random.split(key_dr, num_envs))
    _assert_bits(got["env"], jax.random.split(env_key, num_envs))
    _assert_bits(got["key"], key)
    assert "dr" not in ppo.init_keys(seed, num_envs, False, "cpu")

    tkey, tstep = random.split(got["key"]).unbind(0)
    key, epoch_key = jax.random.split(key)
    _assert_bits(tkey, key)
    tstep, tsgd, tunroll = ppo.training_step_keys(tstep)
    key_, key_sgd, key_unroll = jax.random.split(epoch_key, 3)
    for a, b in ((tstep, key_), (tsgd, key_sgd), (tunroll, key_unroll)):
        _assert_bits(a, b)
    k = key_unroll
    for t_k in ppo.unroll_keys(tunroll, n_unrolls):
        k, k_unroll = jax.random.split(k)
        _assert_bits(t_k, k_unroll)
    for _ in range(2):
        tsgd, perm, loss_keys = ppo.sgd_update_keys(tsgd, n_mb, total)
        key_sgd, key_perm, key_grad = jax.random.split(key_sgd, 3)
        np.testing.assert_array_equal(perm.numpy(), jax.random.permutation(key_perm, total))
        for t_l in loss_keys:
            key_grad, key_loss = jax.random.split(key_grad)
            _assert_bits(t_l, key_loss)
        _assert_bits(tsgd, key_sgd)


def test_evaluator_key_chain_matches_jax():
    """``Evaluator``'s chain (``puppax/train/acting.py:120-124, 164``): per
    evaluation the reset keys and the unroll's key, for 3 evaluations."""
    jkey = jax.random.PRNGKey(4)
    ev = acting.Evaluator(None, None, num_eval_envs=5, episode_length=10, action_repeat=1,
                          key=random.key(4))
    for _ in range(3):
        reset_keys, key_unroll = ev.next_keys()
        jkey, eval_key = jax.random.split(jkey)
        key_reset, jkey_unroll = jax.random.split(eval_key)
        _assert_bits(reset_keys, jax.random.split(key_reset, 5))
        _assert_bits(key_unroll, jkey_unroll)


def test_generate_unroll_key_chain():
    """``generate_unroll`` samples each step from ``current`` of
    ``current, next = split(key)`` (``puppax/train/acting.py:84-91``): the
    policy sees jax's keys in order."""
    seen = []

    class _Env:
        def step(self, state, action):
            return state

    state = dataclasses.make_dataclass("S", ["obs", "reward", "done", "info", "metrics"])(
        torch.zeros(2, 3), torch.zeros(2), torch.zeros(2), {"truncation": torch.zeros(2)}, {})

    def policy(obs, key):
        seen.append(key)
        return torch.zeros(2, 1), {}

    acting.generate_unroll(_Env(), state, policy, random.key(9), 4)
    k = jax.random.PRNGKey(9)
    for got in seen:
        cur, k = jax.random.split(k)
        _assert_bits(got, cur)
