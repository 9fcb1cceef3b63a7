"""Team K3 (``csrc/wrapped_step_team.cuh``) on the CPU: its g++ build against
the one-thread K3's, the plain version and the JAX package, and the K3
wrappers' routing.

Team K3 runs 32 envs per block and splits each env's wrapped step across
the W warps (``team.wrapped_step_team_body``, the rendering team K4 runs
once per step; its schedule runs in lockstep in
``tests/test_torch_team_k4.py::test_wrapped_step_schedule``). These tests

* build team K3 with g++ (W ``std::thread``s per 32-env group, a
  ``std::barrier`` for each barrier) at ``build.TEAM_WARPS`` and at
  ``OTHER_WARPS``, and the one-thread K3 beside them, all at once, and run them on
  the same numpy-seeded inputs at B = 40 (one full 32-env group and a
  ragged one; env 1 restores after a done, envs 2-3 truncate, some feet
  touch the floor): each team build equals the one-thread build bit for
  bit (the same operations in the same order, with the host's math on
  both sides);
* hold the default build against JAX's ``wrapped_step_rows_xla`` and the
  port's plain ``wrapped_step_rows`` on the same inputs, at the tolerances
  of ``tests/test_torch_soa_env.py`` (``H.assert_wrapped_outputs_close``):
  torch's vectorized CPU ``exp`` and ``sqrt`` are not correctly rounded,
  so no g++ build is bit for bit with the plain version here; on the card
  the kernels and the plain version are (``chip_smoke.py``,
  ``tests/test_torch_cuda.py``);
* check ``soa_env.wrapped_step`` (team K3) and
  ``soa_env.wrapped_step_one_thread``: CPU tensors run the plain version
  and count no launch; a device that is neither the CPU nor CUDA raises.
"""

import shutil

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env import soa_env as jax_soa_env
from puppax_torch.env import soa_env
from puppax_torch.kernels import build, cgen, team

torch.set_num_threads(1)

B = 40  # one full group of 32 envs and a partial one
# the second build's warps: 4, unless the production build has 4
OTHER_WARPS = 4 if build.TEAM_WARPS["wrapped_step_team"] != 4 else 8


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """g++ builds (team K3 at ``TEAM_WARPS`` and at ``OTHER_WARPS``, the
    one-thread K3) and the inputs of one wrapped step of ``B`` envs with
    JAX's DR rows."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the team source cannot be built on the host")
    jenv, env = H.jax_env(), H.torch_env()
    s, es, L = env._s, env._es, H.EPISODE_LENGTH
    js = jenv._cv_core._s
    dr = H.jax_dr_rows(js, H.jax_dr_model(jenv, num_envs=B), n=B)
    blocks = H.wrapped_step_blocks(s, es, env.model, dr, np.random.RandomState(0), n=B)
    warps = (build.TEAM_WARPS["wrapped_step_team"], OTHER_WARPS)
    sources = [team.wrapped_step_team_body(s, es, 1, L, w)[0] for w in warps]
    out = tmp_path_factory.mktemp("teamK3")
    default, other, one = build.build_in_parallel(
        lambda: build.host_library(build.WRAPPED_STEP_TEAM, sources[0], out / "default"),
        lambda: build.host_library(build.WRAPPED_STEP_TEAM, sources[1], out / "other"),
        lambda: build.host_library(build.WRAPPED_STEP, cgen.wrapped_step_body(s, es, 1, L), out))
    return dict(env=env, jenv=jenv, blocks=blocks,
                fns={"default": default.wrapped_step_team_host,
                     "other": other.wrapped_step_team_host, "one": one.wrapped_step_host})


def _run_host(fn, env, blocks):
    ins = H.to_torch(blocks)
    outs = [torch.empty((n, B), dtype=torch.float32)
            for n in soa_env.block_rows(env._s, env._es)[1]]
    assert fn(*[t.data_ptr() for t in ins + outs], B) == 0
    return outs


@pytest.mark.parametrize("build_name", ["default", "other"])
def test_team_k3_bit_for_bit_with_one_thread(case, build_name):
    """Team K3 at the production warps and at ``OTHER_WARPS`` equals the one-thread
    K3 bit for bit, the ragged second group included."""
    got = _run_host(case["fns"][build_name], case["env"], case["blocks"])
    want = _run_host(case["fns"]["one"], case["env"], case["blocks"])
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{build_name} team K3: output block {i} differs"


def test_team_k3_matches_jax_and_plain(case):
    """The default team K3 against JAX's XLA wrapped step and the port's
    plain version, on inputs that run the restore, the truncation and the
    contact branches."""
    env, blocks = case["env"], case["blocks"]
    s, es, aux_rows = env._s, env._es, soa_env.aux_row_map(env._es)
    js, jes = case["jenv"]._cv_core._s, case["jenv"]._cv_core._es
    got = [g.numpy() for g in _run_host(case["fns"]["default"], env, blocks)]
    want = [np.asarray(w) for w in jax_soa_env.wrapped_step_rows_xla(
        js, jes, 1, H.EPISODE_LENGTH, *[np.asarray(b) for b in blocks])]
    H.assert_wrapped_outputs_close(got, want, s, es, aux_rows, "g++ team K3 vs JAX xla rows")
    plain = soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH, *H.to_torch(blocks))
    H.assert_wrapped_outputs_close(got, [p.numpy() for p in plain], s, es, aux_rows,
                                   "g++ team K3 vs torch rows")
    done = want[4][aux_rows["done"][0]]
    trunc = want[4][aux_rows["truncation"][0]]
    assert want[3][0, 1] == 1.0 and (trunc[2:4] == 1.0).any() and (done[2:4] == 1.0).all()
    assert 0 < (done > 0.5).sum() < B
    r0, n = es.env_rows["last_contact"]
    assert want[2][r0 : r0 + n].any()


@pytest.mark.parametrize("wrapper", ["wrapped_step", "wrapped_step_one_thread"])
def test_k3_wrappers_on_cpu_run_plain(case, wrapper):
    """Both K3 wrappers: CPU tensors give the plain version's outputs and
    count no launch; a meta tensor (neither CPU nor CUDA) raises."""
    env = case["env"]
    s, es = env._s, env._es
    fn = getattr(soa_env, wrapper)
    ins = H.to_torch(case["blocks"])
    before = (soa_env.wrapped_step.launches, soa_env.wrapped_step_one_thread.launches)
    got = fn(s, es, 1, H.EPISODE_LENGTH, *ins)
    plain = soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH, *ins)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))
    assert (soa_env.wrapped_step.launches, soa_env.wrapped_step_one_thread.launches) == before
    with pytest.raises(ValueError, match=f"{wrapper}: unsupported device meta"):
        fn(s, es, 1, H.EPISODE_LENGTH, *[x.to("meta") for x in ins])


def test_team_k3_build_record():
    """A sweep's team K3 build is its own record; the production build is the
    kernel's name alone, and its shell's entry points are bound by name."""
    k = build.WRAPPED_STEP_TEAM
    assert build.record_name(k, build.team_variant(k, OTHER_WARPS)) == \
        f"wrapped_step_team[{OTHER_WARPS} warps]"
    assert build.record_name(k, build.team_variant(k, build.TEAM_WARPS[k.name])) == \
        "wrapped_step_team"
    assert (k.n_pointers, k.launch, k.host) == (
        build.WRAPPED_STEP.n_pointers, "wrapped_step_team_launch", "wrapped_step_team_host")
    assert build.CSRC / "team.cuh" in k.headers


def test_profile_team_k3_inputs_and_cli():
    """``profile_team --kernel K3``'s inputs: one wrapped step's 8 blocks of a
    DR'd reset (here 8 envs on the CPU), actions in [-1, 1], the DR rows
    differing between envs; its CLI exits without a card."""
    from puppax_torch.probes import profile_team

    env, L, blocks = profile_team.k3_inputs("cpu", B=8)
    in_rows, _ = soa_env.block_rows(env._s, env._es)
    assert build.check_blocks(in_rows, blocks) == (8, torch.device("cpu"))
    assert L == 1000 and blocks[2].abs().max() <= 1
    assert (blocks[5] != blocks[5][:, :1]).any()
    with pytest.raises(SystemExit) as e:
        profile_team.main(["--kernel", "K3"])
    assert "no CUDA device found" in str(e.value)
