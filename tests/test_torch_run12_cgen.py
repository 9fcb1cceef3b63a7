"""The kernels' bodies at run12's env (history 4, privileged rows, the gait
clock, the curriculum) built with g++ on the CPU.

run12's configuration regenerates the bodies of K3 and K4 (history 4, the
``first`` block's 34 privileged rows and the aux block's 34 privileged
rows, restored on done) and of K2 (history 4 only: K2 stores no privileged
rows). One fixture builds, at once, team K3 and the one-thread K3, team K2
and the one-thread K2, team K4 and the one-thread K4, each at the
production warps (``build.TEAM_WARPS``, ``build.K4_MLP_ROWS``), 1 physics
substep, and runs them on numpy-seeded inputs at B = 40 (a full 32-env
group and a ragged one):

* each team build equals its one-thread build bit for bit (the same
  operations in the same order with the host's math on both sides);
* team K3 against JAX's ``wrapped_step_rows_xla`` and the port's plain
  ``wrapped_step_rows`` (env 1 enters done, envs 2-3 truncate and restore
  their privileged rows); team K2 against ``env_step_rows``; team K4 over
  T = 3 steps with episodes of 4 (envs end inside the unroll) against
  ``unroll_rows``; at the tolerances of ``torch_port_helpers``
  (``assert_privileged_close`` for the privileged rows). torch's vectorized
  CPU ``exp`` and ``sqrt`` are not correctly rounded, so no g++ build is
  bit for bit with a plain version here; on the card they are
  (``chip_smoke.py``).
"""

import shutil

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import soa_env as jax_soa_env
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.kernels import build, cgen, team
from puppax_torch.physics import soa

torch.set_num_threads(1)

B = 40  # one full group of 32 envs and a partial one
T = 3
L4 = 4  # K4's episode length: envs reach it inside the unroll


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The six g++ builds at run12's env, built at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated source cannot be built on the host")
    env = PupperV3Env(device="cpu", **H.run12_kwargs(1))
    s, es, L = env._s, env._es, H.EPISODE_LENGTH
    W = build.TEAM_WARPS
    out = tmp_path_factory.mktemp("run12")
    k3_team = team.wrapped_step_team_body(s, es, 1, L, W["wrapped_step_team"])[0]
    k2_team = team.env_step_team_body(s, es, 1, W["env_step_team"])[0]
    k4_team = cgen.fused_unroll_team_body(s, es, 1, L4, W["fused_unroll_team"],
                                          build.K4_MLP_ROWS)[0]
    libs = build.build_in_parallel(
        lambda: build.host_library(build.WRAPPED_STEP_TEAM, k3_team, out / "k3t"),
        lambda: build.host_library(build.WRAPPED_STEP, cgen.wrapped_step_body(s, es, 1, L),
                                   out / "k3"),
        lambda: build.host_library(build.ENV_STEP_TEAM, k2_team, out / "k2t"),
        lambda: build.host_library(build.ENV_STEP, cgen.env_step_body(s, es, 1), out / "k2"),
        lambda: build.host_library(build.FUSED_UNROLL_TEAM, k4_team, out / "k4t"),
        lambda: build.host_library(build.FUSED_UNROLL, cgen.fused_unroll_body(s, es, 1, L4),
                                   out / "k4"))
    names = ("wrapped_step_team_host", "wrapped_step_host", "env_step_team_host",
             "env_step_host", "fused_unroll_team_host", "fused_unroll_host")
    return env, {n: getattr(lib, n) for n, lib in zip(names, libs)}


def _run_host(fn, blocks, out_rows):
    n = blocks[0].shape[1]
    outs = [torch.empty((k, n), dtype=torch.float32) for k in out_rows]
    assert fn(*[t.data_ptr() for t in list(blocks) + outs], n) == 0
    return outs


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None and w is None) or torch.equal(g, w), f"{what}: output {i} differs"


def test_k3_team_one_thread_jax_and_plain(case):
    env, fns = case
    s, es = env._s, env._es
    jenv = JaxEnv(path=None, reward_config=get_config(), **H.run12_kwargs(1))
    js, jes = jenv._cv_core._s, jenv._cv_core._es
    dr = H.jax_dr_rows(js, H.jax_dr_model(jenv, num_envs=B), n=B)
    blocks = H.wrapped_step_blocks(s, es, env.model, dr, np.random.RandomState(0), n=B)
    out_rows = soa_env.block_rows(s, es)[1]
    got = _run_host(fns["wrapped_step_team_host"], H.to_torch(blocks), out_rows)
    one = _run_host(fns["wrapped_step_host"], H.to_torch(blocks), out_rows)
    _assert_equal(got, one, "g++ team K3 vs the one-thread K3 at run12's env")
    aux_rows = soa_env.aux_row_map(es)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in jax_soa_env.wrapped_step_rows_xla(
        js, jes, 1, H.EPISODE_LENGTH, *[np.asarray(b) for b in blocks])]
    H.assert_wrapped_outputs_close(got, want, s, es, aux_rows, "g++ team K3 (run12) vs JAX")
    plain = soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH, *H.to_torch(blocks))
    H.assert_wrapped_outputs_close(got, [p.numpy() for p in plain], s, es, aux_rows,
                                   "g++ team K3 (run12) vs torch rows")
    done = want[3][1] > 0.5
    assert done[2:4].all() and not done.all()
    r0, n = aux_rows["privileged"]
    f0 = s.nq + s.nv + es.hist
    np.testing.assert_array_equal(got[4][r0 : r0 + n][:, done], blocks[6][f0 : f0 + n][:, done])


def test_k2_history4_team_one_thread_and_plain(case):
    env, fns = case
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = H.to_torch(H.env_step_blocks(s, es, env.model, dr, np.random.RandomState(7), n=B))
    out_rows = soa_env.env_block_rows(s, es)[1]
    got = _run_host(fns["env_step_team_host"], blocks, out_rows)
    _assert_equal(got, _run_host(fns["env_step_host"], blocks, out_rows),
                  "g++ team K2 vs the one-thread K2 at history 4")
    want = soa_env.env_step_rows(s, es, 1, *blocks)
    H.assert_env_outputs_close([g.numpy() for g in got], [w.numpy() for w in want], s, es,
                               "g++ team K2 (history 4) vs torch rows")


def test_k4_team_one_thread_and_plain(case):
    env, fns = case
    s, es = env._s, env._es
    layers, blocks = H.fused_unroll_inputs(env, B, T, "elu", L4)
    got = fused_unroll.kernel_call(fns["fused_unroll_team_host"], s, es, "elu", layers,
                                   fused_unroll.team_weights(layers), *blocks)
    one = fused_unroll.kernel_call(fns["fused_unroll_host"], s, es, "elu", layers,
                                   fused_unroll.one_thread_weights(layers), *blocks)
    _assert_equal(got, one, "g++ team K4 vs the one-thread K4 at run12's env")
    want = fused_unroll.unroll_rows(s, es, 1, L4, "elu", layers, *blocks)
    aux_rows = soa_env.aux_row_map(es)
    for t in range(T):
        H.assert_wrapped_outputs_close(
            [x.numpy() for x in got[:4] + (got[9][t],)],
            [x.numpy() for x in want[:4] + (want[9][t],)], s, es, aux_rows,
            f"g++ team K4 (run12) vs plain, step {t}")
    for i, name in ((5, "obs"), (6, "act"), (7, "raw")):
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got[8].numpy(), want[8].numpy(), atol=2e-4, err_msg="logp")
    np.testing.assert_allclose(got[4].numpy(), want[4].numpy(), rtol=0, atol=1e-6,
                               err_msg="phase")
    done = want[9][:, aux_rows["done"][0]] > 0.5
    assert done.any() and not done.all()
    # the done envs' privileged rows are the first block's
    r0, n = aux_rows["privileged"]
    f0 = s.nq + s.nv + es.hist
    first = blocks[5][f0 : f0 + n]
    for t in range(T):
        np.testing.assert_array_equal(got[9][t][r0 : r0 + n][:, done[t]].numpy(),
                                      first[:, done[t]].numpy())


def test_kernels_are_keyed_by_the_statics_content():
    """Two envs built alike share their kernels' key (the training CLI's env
    and a caller's: no body is rendered twice); another history, privileged
    rows or substep count, or no statics at all (the probes), key apart."""
    def key(env):
        return build._statics_digest(env._s, env._es)

    run12 = PupperV3Env(device="cpu", **H.run12_kwargs(1))
    assert key(run12) == key(PupperV3Env(device="cpu", **H.run12_kwargs(1)))
    others = [PupperV3Env(device="cpu", **kw) for kw in (
        H.env_kwargs(1), dict(H.env_kwargs(1), observation_history=4), H.run12_kwargs(2))]
    assert len({key(run12), *map(key, others)}) == 4
    assert build._statics_digest(None, None) == build._statics_digest(None, None)
    assert build._statics_digest(run12._s, None) != key(run12)
