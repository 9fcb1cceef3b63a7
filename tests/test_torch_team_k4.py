"""Team K4 (``csrc/fused_unroll_team.cuh``) on the CPU: its schedule, its g++
build against the one-thread K4 and the plain version, and the slice
against the JAX package.

Team K4 runs 32 envs per block and splits each env's step across the W
warps: K3's program by ``kernels/team.py`` (``team.wrapped_step_team_body``),
the MLP by chunks of ``K4_R`` outputs. These tests

* check ``team.Schedule`` on K3's program (``cgen.wrapped_step_program``):
  the rendered streams run symbolically in lockstep
  (``test_torch_team._lockstep``: every operand the one-thread program's,
  every cross-warp read after its write and a barrier), the same barrier
  count in every stream, the slots within ``team.SHARED_BUDGET``;
* build team K4 with g++ (W ``std::thread``s per 32-env group, a
  ``std::barrier`` for each barrier; one build at ``TEAM_WARPS`` and
  ``K4_MLP_ROWS``, one at 4 warps and 3 outputs per thread, so a layer's
  last chunk is partial) and the one-thread K4 beside them, and run them
  through ``fused_unroll.kernel_call`` at B = 40 (one full 32-env group and
  a partial one) and T = 3, the clock and the activation chosen at run
  time: team K4 equals the one-thread K4 bit for bit (the same operations
  in the same order, with the host's math on both sides), and the plain
  version ``unroll_rows`` at the parity tolerances of
  ``tests/test_torch_fused_cgen.py`` (K3's for the carry and aux; obs, act
  and raw 1e-5; log-prob 2e-4; phase 1e-6): torch's vectorized CPU
  ``exp``, ``tanh`` and ``sqrt`` are not correctly rounded, so the plain
  version on the CPU is not bit for bit with any g++ build. On the card
  the two are bit for bit (``chip_smoke.py``, ``tests/test_torch_cuda.py``);
* hold the slice against ``puppax``: JAX's real ``build_unroll_kernel`` in
  Pallas interpret mode, with ``tests/test_fused_unroll.py``'s stubbed env
  step, against team K4's g++ build of the same stub emitted through
  ``cgen.CProgram`` (the shell, the MLP, the head, the carry and the clock
  are the real ones), on the same state and draws, as
  ``tests/test_torch_fused_unroll.py::test_plumbing_matches_pallas_interpret``
  holds ``unroll_rows``, at its tolerances: 1e-5 for the transitions and
  the final state, 2e-4 for the log-prob (JAX sums its MLP in another
  order), 1e-6 for the phase.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_fused_unroll as jtest
import test_torch_fused_unroll as fused_tests
import test_torch_team as team_tests
import torch_port_helpers as H
from puppax.env import rollout as jrollout
from puppax.env import soa_env as jsoa_env
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.kernels import build, cgen, team
from puppax_torch.physics import soa
from puppax_torch.train import networks as tnets

torch.set_num_threads(1)

T = 3
L = 4  # episode length: every env reaches its limit inside the unroll
B = 40  # one full group of 32 envs and a partial one
OTHER = (4, 3)  # warps and MLP outputs per thread of the second build


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the team source cannot be built on the host")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """g++ builds: team K4 at the production warps and MLP rows, team K4
    at ``OTHER``, the one-thread K4."""
    _need_gxx()
    env = H.torch_env()
    s, es = env._s, env._es
    out = tmp_path_factory.mktemp("teamK4")
    default = (build.TEAM_WARPS["fused_unroll_team"], build.K4_MLP_ROWS)
    sources = [cgen.fused_unroll_team_body(s, es, 1, L, w, r)[0] for w, r in (default, OTHER)]
    team_lib, other_lib, one_lib = build.build_in_parallel(
        lambda: build.host_library(build.FUSED_UNROLL_TEAM, sources[0], out / "default"),
        lambda: build.host_library(build.FUSED_UNROLL_TEAM, sources[1], out / "other"),
        lambda: build.host_library(build.FUSED_UNROLL, cgen.fused_unroll_body(s, es, 1, L), out))
    return {"team": team_lib.fused_unroll_team_host, "other": other_lib.fused_unroll_team_host,
            "one": one_lib.fused_unroll_host}


def test_wrapped_step_schedule():
    """K3's program across 4 warps (the fixture renders it at the production
    warps too): lockstep parity with the one-thread program, equal barriers
    in every stream, the slots within one block's shared memory, every
    stream shorter than the program."""
    warps = 4
    env = H.torch_env()
    prog = cgen.wrapped_step_program(env._s, env._es, 1, L)
    sch = team.Schedule(prog, warps)
    streams = team.render_streams(sch)
    barriers, computed, runs = team_tests._lockstep(streams, prog, sch)
    assert set(computed) == set(runs)
    assert barriers > 0 and all(team.stream_barriers(x) == barriers for x in streams)
    assert 4 * sch.shared_floats <= team.SHARED_BUDGET
    ops = [team.stream_ops(x) for x in streams]
    base = cgen.op_count("\n".join(prog.lines))
    assert sum(ops) == base + sch.replicated_ops()
    assert max(ops) < base / 2
    source, stats = team.wrapped_step_team_body(env._s, env._es, 1, L, warps)
    assert stats["barriers"] == barriers and stats["shared_bytes"] == 4 * sch.shared_floats
    assert "wrapped_step_team_body(WS_PARAMS" in source


def test_team_k4_renders_team_k3_body_once(monkeypatch):
    """``build._team_k3_body`` renders team K3's schedule once per
    configuration, and team K4 runs that rendering after its constants."""
    monkeypatch.setattr(build, "_TEAM_K3_BODIES", {})
    env = H.torch_env()
    s, es, w = env._s, env._es, build.TEAM_WARPS["fused_unroll_team"]
    direct = team.wrapped_step_team_body(s, es, 1, L, w)
    first = build._team_k3_body(s, es, 1, L, w)
    assert first == direct and len(build._TEAM_K3_BODIES) == 1
    again = build._team_k3_body(s, es, 1, L, w)
    assert again[0] is first[0] and again == direct
    source, stats = cgen.fused_unroll_team_body(s, es, 1, L, w, build.K4_MLP_ROWS, team_k3=again)
    assert source.endswith(direct[0]) and stats == direct[1]


def _inputs(gait: bool, activation: str):
    env = PupperV3Env(device="cpu", gait_phase_observation=gait, **H.env_kwargs(1))
    layers, blocks = H.fused_unroll_inputs(env, B, T, activation, L)
    return env, layers, blocks


def _call(fn, env, activation, layers, blocks, team_layout=True):
    weights = (fused_unroll.team_weights if team_layout else fused_unroll.one_thread_weights)(
        layers)
    return fused_unroll.kernel_call(fn, env._s, env._es, activation, layers, weights, *blocks)


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None and w is None) or torch.equal(g, w), f"{what}: output {i} differs"


def _assert_close_to_plain(got, want, env, gait, what):
    s, es = env._s, env._es
    aux_rows = soa_env.aux_row_map(es)
    for t in range(T):  # the final carry, with each step's aux rows
        H.assert_wrapped_outputs_close(
            [x.numpy() for x in got[:4] + (got[9][t],)],
            [x.numpy() for x in want[:4] + (want[9][t],)], s, es, aux_rows, f"{what}, step {t}")
    for i, name in ((5, "obs"), (6, "act"), (7, "raw")):
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), atol=1e-5,
                                   err_msg=f"{what}: {name}")
    np.testing.assert_allclose(got[8].numpy(), want[8].numpy(), atol=2e-4,
                               err_msg=f"{what}: logp")
    done = want[9][:, aux_rows["done"][0]]
    assert (done == 1).any() and (done == 0).any()
    if gait:
        np.testing.assert_allclose(got[4].numpy(), want[4].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("activation", ["elu", "softmax"])
@pytest.mark.parametrize("gait", [False, True], ids=["gait-off", "gait-on"])
def test_team_k4_against_one_thread_and_plain(libs, gait, activation):
    """Team K4's g++ build: bit for bit with the one-thread K4's, and at the
    parity tolerances with ``unroll_rows``."""
    env, layers, blocks = _inputs(gait, activation)
    got = _call(libs["team"], env, activation, layers, blocks)
    one = _call(libs["one"], env, activation, layers, blocks, team_layout=False)
    what = f"g++ team K4, {activation}, gait {gait}"
    _assert_equal(got, one, f"{what} vs the one-thread K4")
    want = fused_unroll.unroll_rows(env._s, env._es, 1, L, activation, layers, *blocks)
    _assert_close_to_plain(got, want, env, gait, f"{what} vs plain")


def test_team_k4_other_warps_and_rows(libs):
    """Team K4 on 4 warps, 3 MLP outputs per thread (the last chunk of the
    32-wide layers and of the 24 logits partial or whole): bit for bit with
    the one-thread K4, the clock on, tanh."""
    env, layers, blocks = _inputs(True, "tanh")
    got = _call(libs["other"], env, "tanh", layers, blocks)
    one = _call(libs["one"], env, "tanh", layers, blocks, team_layout=False)
    _assert_equal(got, one, "g++ team K4 on 4 warps, R = 3, vs the one-thread K4")


def test_team_k4_refuses_through_the_wrapper(libs):
    """``kernel_call`` checks what team K4 takes before it calls the
    kernel, and raises if the kernel reports an error."""
    env, layers, blocks = _inputs(False, "elu")
    with pytest.raises(ValueError, match="logits"):
        _call(libs["team"], env, "elu", layers[:-1], blocks)
    with pytest.raises(RuntimeError, match="fused unroll kernel failed"):
        fused_unroll.kernel_call(lambda *a: 1, env._s, env._es, "elu", layers,
                                 fused_unroll.team_weights(layers), *blocks)


def _fmod(x, c: float):
    """``fmod(x, c)`` on either back-end of the emission."""
    if isinstance(x, torch.Tensor):
        return torch.fmod(x, c)
    return x._bk.emit("f", "fmodf({}, {})", x.name, cgen.float_literal(c))


def _stub_emission(s, es, q, v, act, env, noi, dr, first_q, first_v, first_obs, first_priv,
                   steps, prev_done, n_substeps, episode_length):
    """``tests/test_fused_unroll.py::_stub_emission`` with the port's
    emission signature (the privileged rows unused, as there), on either
    back-end."""
    nu = s.nu
    noi0 = next(iter(noi.values()))[0]
    dr0 = next(iter(dr.values()))[0]
    steps2 = steps + 1.0
    done2 = soa.where(_fmod(steps2, 3.0) < 0.5, 1.0, 0.0)
    trunc = done2 * 0.5

    def mix(base, i, scale):
        return base * 0.9 + 0.03 * act[i % nu] + scale * noi0 + 0.001 * dr0

    q_out = [soa.where(done2 > 0.5, first_q[i], mix(q[i], i, 0.01)) for i in range(s.nq)]
    v_out = [soa.where(done2 > 0.5, first_v[i], mix(v[i], i, 0.02)) for i in range(s.nv)]
    env_out = {}
    for name, (_, n) in es.env_rows.items():
        rows = env[name]
        if name == "obs_history":
            env_out[name] = [soa.where(done2 > 0.5, first_obs[i], mix(rows[i], i, 0.005))
                             for i in range(n)]
        else:
            env_out[name] = [mix(rows[i], i, 0.002) for i in range(n)]
    aux = {
        "reward": [0.1 * act[0] + 0.01 * noi0],
        "done": [done2],
        "truncation": [trunc],
        "rewards": [q[0] * 0.001 * (i + 1) for i in range(18)],
        "total_dist": [q[1] * 0.5],
    }
    return q_out, v_out, env_out, steps2, done2, aux


def test_team_k4_matches_pallas_interpret(tmp_path, monkeypatch):
    """JAX's ``build_unroll_kernel`` in interpret mode and team K4's g++
    build, both around the stubbed env step, on the same state and draws:
    T = 3 with periodic dones, the clock on, 8 envs (a partial 32-env
    group)."""
    _need_gxx()
    monkeypatch.setattr(jsoa_env, "_emit_wrapped_step", jtest._stub_emission)
    monkeypatch.setattr(soa_env, "_emit_wrapped_step", _stub_emission)
    monkeypatch.setenv("PUPPAX_SOA_ENV", "force")
    monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "on")
    jenv, jwrapped, _, params = jtest._make(gait=True)
    jstate = jtest._reset(jwrapped)
    # the stub ends an episode every third step: stagger the envs' counts;
    # start the clocks apart, some just short of 2 pi
    jstate = jstate.replace(info=dict(
        jstate.info, steps=jnp.asarray(np.arange(H.B) % 3, jnp.float32),
        gait_phase=jnp.asarray(np.linspace(0.5, 6.27, H.B), jnp.float32)))
    key = jax.random.PRNGKey(5)
    jlane = jrollout.FastLane(jwrapped, mode="interpret")
    assert jlane.use_fused(T)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jfinal, jdata = to_np(jlane.unroll(jstate, (None, params), key, T, jax.nn.elu))
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, : H.B]

    tenv = PupperV3Env(device="cpu", gait_phase_observation=True, **H.env_kwargs(1))
    s, es = tenv._s, tenv._es
    source, _ = cgen.fused_unroll_team_body(s, es, 1, jtest.EPISODE_LENGTH,
                                            build.TEAM_WARPS["fused_unroll_team"],
                                            build.K4_MLP_ROWS)
    fn = build.host_library(build.FUSED_UNROLL_TEAM, source, tmp_path).fused_unroll_team_host
    called = []

    def team_k4(s_, es_, n_substeps, episode_length, activation, layers, *blocks):
        called.append(1)
        return fused_unroll.kernel_call(fn, s_, es_, activation, layers,
                                        fused_unroll.team_weights(layers), *blocks)

    monkeypatch.setattr(fused_unroll, "unroll_rows", team_k4)
    policy = tnets.make_ppo_networks(tenv.observation_size, tenv.action_size, (32, 32),
                                     (32, 32), device="cpu").policy_network
    policy.load_state_dict(tnets.params_from_jax(to_np(params)))
    tlane = FastLane(wrap_for_training(tenv, jtest.EPISODE_LENGTH))
    assert tlane.use_fused(T)
    tfinal, tdata = tlane.unroll_from_draws(
        state_from_jax(to_np(jstate)), (None, policy), torch.from_numpy(np.array(noise)),
        torch.from_numpy(fused_tests._eps_from_key(key, T, H.B)),
        torch.from_numpy(np.array(last_kick)))
    assert called == [1]

    atol = 1e-5
    for name in ("observation", "action", "reward", "discount", "next_observation",
                 "truncation"):
        np.testing.assert_allclose(getattr(tdata, name).numpy(), getattr(jdata, name),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tdata.policy_extras["raw_action"].numpy(),
                               jdata.policy_extras["raw_action"], atol=atol)
    np.testing.assert_allclose(tdata.policy_extras["log_prob"].numpy(),
                               jdata.policy_extras["log_prob"], atol=2e-4)
    assert all((jdata.discount[t] == 0).any() and (jdata.discount[t] == 1).any()
               for t in range(T))
    np.testing.assert_allclose(tfinal.obs.numpy(), jfinal.obs, atol=atol)
    np.testing.assert_allclose(tfinal.qpos.numpy(), jfinal.pipeline_state.qpos, atol=atol)
    np.testing.assert_array_equal(tfinal.done.numpy(), jfinal.done)
    for name in ("steps", "truncation"):
        np.testing.assert_allclose(tfinal.info[name].numpy(), jfinal.info[name], atol=atol)
    np.testing.assert_allclose(tfinal.info["gait_phase"].numpy(), jfinal.info["gait_phase"],
                               atol=1e-6)
    assert (jfinal.info["gait_phase"] == 0).any() and (jfinal.info["gait_phase"] > 0).any()
