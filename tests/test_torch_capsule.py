"""The capsule pairs and ``path=`` in the port against puppax's.

The capsule-legged Pupper (``bench.py``'s ``capsule`` variant: the bundled
model's 4 foot spheres as capsules of radius 0.015 and half-length 0.02)
reaches the port as the JAX package reaches it, through ``env.path``:

* the tables: the committed ``mjcf_<digest>_tables.json`` is what the
  writer (``python -m puppax_torch.model.tables --set env.path=<file>``)
  writes, its pair lists (4 plane-sphere, 6 sphere-sphere, 4
  plane-capsule, 12 sphere-capsule, 6 capsule-capsule) and leaves
  ``puppax.model.mjcf.load_model``'s, and the emitter's 36 contacts
  (two plane-capsule rows a pair, ends interleaved) JAX's ``_Static``'s;
* ``path=``: the tables' key is the MJCF's content, not its name or
  directory; other content keys another file; a missing file raises,
  naming the writer; an MJCF that reads other files raises;
* the env from ``path=`` against JAX's ``PupperV3Env(path=...)``: reset and
  two wrapped steps under the same draws (the port's standard step runs the
  plain K2; JAX's XLA step core with the MJX caps raised to 32, since a
  standing capsule robot has 8 plane-capsule rows and the emission is
  uncapped by design);
* the emission's torch rows on states with the first envs pinned near
  standing (plane-capsule rows active): the plain K1 against JAX's XLA
  ``pipeline_step`` with the caps raised, the plain K3 against JAX's
  ``wrapped_step_rows_xla``, the fused lane (the plain K4) at T = 2 against
  JAX's xla ``FastLane``: qpos 5e-5, scaled qvel 5e-4, obs and reward
  2e-4, done exact;
* the g++ builds of team K1-K4[capsule] bit for bit with the g++
  one-thread bodies, and team K3 within tolerance of JAX;
* in float64, ``collision._plane_capsule`` / ``_sphere_capsule`` /
  ``_capsule_capsule`` against puppax's at 1e-10 (dist, pos, frame) on
  ``tests/test_capsule.py``'s free-capsule scene and the capsule Pupper at
  random poses, and ``pipeline_step`` (the MJX caps as they are) at the
  tolerances of ``tests/test_torch_pipeline.py``.
"""

import dataclasses
import os
import shutil
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fused_unroll as fused_tests
import torch_port_helpers as H
from test_capsule import _capsule_pupper_xml as capsule_xml
from test_capsule import _free_capsules_xml
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import domain_randomization as jdr
from puppax.env import rollout as jrollout
from puppax.env import soa_env as jax_soa_env
from puppax.env import wrappers as jwrappers
from puppax.model.mjcf import load_model as jax_load_model
from puppax.physics import collision as jcol
from puppax.physics import pipeline as jpipe
from puppax.physics import smooth as jsmooth
from puppax.physics import soa as jsoa
from puppax.train import running_statistics as jstats
from puppax_torch.configs.experiment import EnvConfig
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.env.rollout import FastLane
from puppax_torch.env.wrappers import wrap_for_training
from puppax_torch.kernels import build, cgen, team
from puppax_torch.model import mjcf, tables, terrain
from puppax_torch.physics import collision, pipeline, smooth, soa
from puppax_torch.train import running_statistics as tstats

torch.set_num_threads(1)

NB = 40  # a full 32-env group and a ragged one
T = 2
OBS = 72
KINDS = ("ps", "ss", "pc", "sc", "cc")


def _raise_caps(model):
    return model.replace(max_contact_points=32, max_geom_pairs=32)


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    """The capsule MJCF as a file, the port's env from ``path=`` and JAX's
    (1 substep), JAX's with the MJX caps raised to 32."""
    path = tmp_path_factory.mktemp("capsule") / "pupper_capsule.xml"
    path.write_text(capsule_xml())
    tenv = PupperV3Env(path=str(path), device="cpu", **H.env_kwargs(1))
    jenv = JaxEnv(path=str(path), reward_config=get_config(), **H.env_kwargs(1))
    jenv.model = _raise_caps(jenv.model)
    return str(path), tenv, jenv


def _standing(model, n: int) -> np.ndarray:
    """(n, nq) qpos at the model's key pose, the base lowered so that the
    lowest capsule end presses 1, 2, ... mm into the floor."""
    m = pipeline.model_tensors(model, torch.float32, "cpu")
    q = np.tile(np.asarray(model.key_qpos, np.float32), (n, 1))
    dist = collision.collide_pairs(m, smooth.kinematics(m, torch.from_numpy(q[:1]))).dist
    lowest = float(dist[0, len(model.pairs_plane_sphere) + len(model.pairs_sphere_sphere):][
        :2 * len(model.pairs_plane_capsule)].min())
    q[:, 2] -= lowest + 0.001 * np.arange(1, n + 1, dtype=np.float32)
    return q


def _pinned_states(model, rng, n=NB):
    """``random_states`` with the first 4 envs standing on their capsule
    feet (``_standing``), their velocities scaled down."""
    qpos, qvel, ctrl = H.random_states(model, rng, n)
    qpos[:4] = _standing(model, 4)
    qvel[:4] *= 0.1
    return qpos, qvel, ctrl


def _kind_counts(s, con_dist) -> np.ndarray:
    """(n, 5) penetrating rows per kind (ps, ss, pc, sc, cc) of a
    ``(npair, n)`` block of contact distances."""
    kinds = np.array([p.kind for p in s.pairs])
    pen = np.asarray(con_dist) < 0
    return np.stack([pen[kinds == k].sum(0) for k in KINDS], 1)


# ---- the tables and path= ----


def test_capsule_tables_match_jax(caps, tmp_path):
    """The committed tables are a fresh write's, byte for byte; the pair
    lists and leaves are puppax's compile of the same file; the emitter's
    pairs are JAX's ``_Static``'s, field by field."""
    path, tenv, _ = caps
    committed = mjcf.config_tables_path(EnvConfig(path=path))
    assert os.path.basename(committed).startswith("mjcf_")
    out = tmp_path / "caps.json"
    tables.write_config_tables(EnvConfig(path=path), str(out))
    with open(committed, "rb") as f:
        assert out.read_bytes() == f.read()
    got = mjcf.load_model(committed).robot
    cm = jax_load_model(path)
    want = cm.robot
    for name in mjcf.STATIC_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    for name in mjcf.LEAF_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert [len(getattr(got, f"pairs_{k}")) for k in (
        "plane_sphere", "sphere_sphere", "plane_capsule", "sphere_capsule",
        "capsule_capsule")] == [4, 6, 4, 12, 6]
    assert (got.max_contact_points, got.max_geom_pairs) == (5, 4)
    s, js = tenv._s, jsoa._Static(cm.robot, cm.mj_model)  # both from MuJoCo's float64 tables
    assert s.npair == js.npair == 36 and soa.soa_supported(tenv.model)
    pc = [p for p in s.pairs if p.kind == "pc"]
    assert [p.cap_end for p in pc] == [0, 1] * 4
    assert [p.geom2 for p in pc] == [g for _, g in got.pairs_plane_capsule for _ in (0, 1)]
    for p, q in zip(s.pairs, js.pairs):
        for f in q._fields:
            a, b = getattr(p, f), getattr(q, f)
            assert np.allclose(a, b, rtol=0, atol=1e-7) if f != "kind" else a == b, (f, a, b)
    assert build.model_variant(s) == "capsule"
    assert build.record_name(build.FUSED_UNROLL_TEAM, build.model_variant(s)) == \
        "fused_unroll_team[capsule]"


def test_path_keys_and_raises(caps, tmp_path):
    """The key is the MJCF's content in canonical form: the same model under
    another name, in another directory, indented and with its attributes in
    another order keys the same tables; another model keys another file,
    whose absence raises naming the writer; an MJCF that reads other files
    raises; under a terrain the key holds both parts and the surgery applies
    to the file's tree."""
    path = caps[0]
    key = mjcf.tables_path(EnvConfig(path=path))
    other_dir = tmp_path / "a" / "b"
    other_dir.mkdir(parents=True)
    copy = other_dir / "robot.mjcf"
    tree = ET.ElementTree(ET.fromstring(capsule_xml()))
    ET.indent(tree)
    for el in tree.getroot().iter():
        el.attrib = dict(reversed(list(el.attrib.items())))
    copy.write_text(ET.tostring(tree.getroot(), encoding="unicode"))
    assert mjcf.tables_path(EnvConfig(path=str(copy))) == key
    heavier = tmp_path / "heavier.xml"
    heavier.write_text(capsule_xml().replace('size="0.015 0.02"', 'size="0.016 0.02"', 1))
    assert mjcf.tables_path(EnvConfig(path=str(heavier))) != key
    with pytest.raises(FileNotFoundError,
                       match="python -m puppax_torch.model.tables --set env.path="):
        PupperV3Env(path=str(heavier), device="cpu")
    included = tmp_path / "included.xml"
    included.write_text('<mujoco><include file="pupper_capsule.xml"/></mujoco>')
    for call in (lambda: mjcf.tables_path(EnvConfig(path=str(included))),
                 lambda: tables.write_config_tables(EnvConfig(path=str(included)),
                                                    str(tmp_path / "t.json"))):
        with pytest.raises(NotImplementedError, match="reads other files"):
            call()
    hf = dataclasses.replace(EnvConfig(path=path), heightfield=True)
    name = os.path.basename(mjcf.tables_path(hf))
    assert name.startswith(os.path.basename(key)[:len("mjcf_") + 12] + "_hfield_")
    want = terrain.add_heightfield_to_model(ET.parse(path), nrow=hf.heightfield_nrow,
                                            ncol=hf.heightfield_ncol, size=hf.heightfield_size,
                                            seed=hf.heightfield_seed)
    assert tables.config_xml(hf) == ET.tostring(want.getroot(), encoding="unicode")


# ---- the env from path= and the emission (float32) ----


@pytest.fixture(scope="module")
def wrapped_pair(caps):
    """JAX's wrapped env and the port's from ``path=`` with the same DR
    leaves and reset; env 1 done, envs 2-3 at the episode limit, envs 4-7
    pinned near standing."""
    _, tenv, jenv = caps
    jwrapped = jwrappers.wrap_for_training(
        jenv, H.EPISODE_LENGTH, randomization_fn=jdr.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(5), H.B))
    jstate = jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), H.B))
    steps = np.zeros(H.B, np.float32)
    steps[2:4] = H.EPISODE_LENGTH - 1
    done = np.zeros(H.B, np.float32)
    done[1] = 1.0
    jreset = jax.tree_util.tree_map(np.asarray, jstate)
    qpos = np.array(jstate.pipeline_state.qpos)
    qpos[4:8] = _standing(tenv.model, 4)
    jstate = jstate.replace(
        done=jnp.asarray(done), info=dict(jstate.info, steps=jnp.asarray(steps)),
        pipeline_state=jstate.pipeline_state.replace(qpos=jnp.asarray(qpos)))
    leaves = H.dr_leaves(jwrapped.env._model)
    twrapped = wrap_for_training(tenv, H.EPISODE_LENGTH,
                                 randomization_fn=lambda m, keys: m.with_leaves(**leaves),
                                 randomization_keys=H.env_keys(H.B))
    return jenv, jwrapped, jstate, twrapped, jreset


def test_env_from_path_matches_jax(wrapped_pair):
    """Reset (the same draws) and two wrapped steps under the same noise
    and actions: the port's standard step (the plain K2) against JAX's
    (its XLA step core, the caps raised)."""
    from test_torch_env import _jax_reset_draws
    from test_torch_env_step import _cache_block, _ps_block

    jenv, jwrapped, jstate, twrapped, jreset = wrapped_pair
    rngs = jax.random.split(jax.random.PRNGKey(3), H.B)
    draws = {k: torch.from_numpy(v) for k, v in _jax_reset_draws(jenv, rngs).items()}
    treset = twrapped.reset_from_draws(draws)
    np.testing.assert_array_equal(treset.qpos.numpy(), jreset.pipeline_state.qpos)
    np.testing.assert_allclose(treset.obs.numpy(), jreset.obs, atol=2e-6)

    tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    jstep = jax.jit(jwrapped.step)
    draw = jax.jit(jax.vmap(jenv._draw_step_noise))
    rng = np.random.RandomState(9)
    s = twrapped.env._s
    pc_active = 0
    for t in range(2):
        noise = {k: torch.from_numpy(np.array(v)) for k, v in draw(jstate.info["rng"]).items()
                 if k in jenv._CORE_NOISE_KEYS}
        act = rng.uniform(-1, 1, (H.B, 12)).astype(np.float32)
        jstate = jstep(jstate, jnp.asarray(act))
        tstate = twrapped.step_from_draws(tstate, torch.from_numpy(act), noise)
        j = jax.tree_util.tree_map(np.asarray, jstate)
        what = f"step {t}"
        close = np.testing.assert_allclose
        np.testing.assert_array_equal(tstate.done.numpy(), j.done, err_msg=what)
        for name in ("steps", "truncation", "step", "last_contact"):
            np.testing.assert_array_equal(tstate.info[name].numpy(), j.info[name],
                                          err_msg=f"{what} {name}")
        close(tstate.qpos.numpy(), j.pipeline_state.qpos, atol=5e-5, err_msg=f"{what} qpos")
        close(tstate.obs.numpy(), j.obs, atol=2e-4, err_msg=f"{what} obs")
        close(tstate.reward.numpy(), j.reward, atol=2e-4, err_msg=f"{what} reward")
        scale = np.maximum(1.0, np.abs(j.pipeline_state.qvel).max(1, keepdims=True))
        close(tstate.qvel.numpy() / scale, j.pipeline_state.qvel / scale, atol=5e-4,
              err_msg=f"{what} qvel")
        H.assert_cache_rows_close(_ps_block(tstate.pipeline_state),
                                  _cache_block(s, j.pipeline_state), s, what)
        pc_active += int((_kind_counts(s, j.pipeline_state.contact.dist.T)[:, 2] > 0).sum())
    assert pc_active >= 4


@pytest.fixture(scope="module")
def k3_inputs(caps):
    """K3's input blocks with JAX's DR rows, the first 4 envs pinned near
    standing, and JAX's wrapped step on them (the emission as XLA ops)."""
    _, tenv, jenv = caps
    s, es = tenv._s, tenv._es
    js, jes = jenv._cv_core._s, jenv._cv_core._es
    dr = H.jax_dr_rows(js, H.jax_dr_model(jenv, num_envs=NB), n=NB)
    rng = np.random.RandomState(0)
    blocks = H.wrapped_step_blocks(s, es, tenv.model, dr, rng, n=NB)
    qpos, qvel, _ = _pinned_states(tenv.model, rng)
    blocks[0][:, :4], blocks[1][:, :4] = qpos[:4].T, qvel[:4].T
    blocks[7][:, :4] = 0.0  # those four neither done nor truncated
    want = [np.asarray(w) for w in jax_soa_env.wrapped_step_rows_xla(
        js, jes, 1, H.EPISODE_LENGTH, *blocks)]
    return blocks, want


def test_k3_torch_rows_match_jax(caps, k3_inputs):
    _, tenv, _ = caps
    s, es = tenv._s, tenv._es
    blocks, want = k3_inputs
    got = [g.numpy() for g in soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH,
                                                        *H.to_torch(blocks))]
    H.assert_wrapped_outputs_close(got, want, s, es, soa_env.aux_row_map(es),
                                   "capsule torch rows vs JAX")
    m = pipeline.model_tensors(tenv.model, torch.float32, "cpu")
    dist = collision.collide_pairs(m, smooth.kinematics(m, torch.from_numpy(
        blocks[0].T.copy()))).dist.numpy()
    assert (_kind_counts(s, dist.T)[:4, 2] > 0).all()  # the pinned envs stand on capsules


def test_k1_torch_rows_match_jax_pipeline(caps, monkeypatch):
    """The plain K1[capsule] against JAX's XLA ``pipeline_step`` (1 substep)
    with the caps raised to 32, so every env is held; the pinned envs' plane-
    capsule rows are active, and the sphere-capsule and capsule-capsule
    distances are held in every env. On a DR batch the gap is the emission's
    line search, as ``tests/test_torch_physics_step.py`` shows for the flat
    model: both sides run it to convergence here."""
    from test_torch_physics_step import _cache_block

    _, tenv, jenv = caps
    s = tenv._s
    jm, in_axes = jdr.domain_randomize(jenv.model, jax.random.split(jax.random.PRNGKey(5), NB))
    dr = H.jax_dr_rows(jenv._cv_core._s, jm, n=NB)
    qpos, qvel, ctrl = _pinned_states(tenv.model, np.random.RandomState(1))
    blocks = [qpos.T.copy(), qvel.T.copy(), ctrl.T.copy(), dr]
    step = jax.jit(jax.vmap(lambda m, qp, qv, ct: jpipe.pipeline_step(
        m, jpipe._zeros_state(m, qp, qv), ct, 1), in_axes=(in_axes, 0, 0, 0)))
    ps = jax.tree_util.tree_map(np.asarray, step(jm, qpos, qvel, ctrl))
    monkeypatch.setattr(soa, "LS_EXPAND_ITERS", 40)
    monkeypatch.setattr(soa, "LS_ILLINOIS_ITERS", 200)
    got = [g.numpy() for g in soa.physics_step_rows(s, 1, *H.to_torch(blocks))]
    want = [ps.qpos.T, ps.qvel.T, _cache_block(s, ps)]
    H.assert_physics_outputs_close(got, want, s, "K1[capsule] plain vs XLA pipeline_step")
    r0, n = s.cache_rows["con_dist"]
    assert (_kind_counts(s, got[2][r0:r0 + n])[:4, 2] > 0).all()


def test_fused_lane_matches_jax(wrapped_pair):
    """The fused lane (the plain K4[capsule]) at T = 2 against JAX's xla
    ``FastLane`` and against the port's K3 lane, on the same draws, from
    ``wrapped_pair``'s state (envs 4-7 standing, env 1 done, envs 2-3 at
    the episode limit)."""
    _, jwrapped, jstate, twrapped, _ = wrapped_pair
    B = H.B
    params, policy = fused_tests._policy("elu")
    norm = jstats.init_state(OBS).replace(mean=jnp.linspace(-0.1, 0.1, OBS),
                                          std=jnp.linspace(0.9, 1.1, OBS))
    key_ = jax.random.PRNGKey(11)
    jlane = jrollout.FastLane(jwrapped, mode="xla")
    jfinal, jdata = fused_tests._np(jlane.unroll(jstate, (norm, params), key_, T, jax.nn.elu))
    _, tiles, last_kick = jlane.draw_noise_block(jstate.info["rng"], T)
    noise = np.asarray(tiles).reshape(T, tiles.shape[1], -1)[:, :, :B]

    tlane = FastLane(twrapped)
    draws = (torch.from_numpy(np.array(noise)),
             torch.from_numpy(fused_tests._eps_from_key(key_, T, B)),
             torch.from_numpy(np.array(last_kick)))
    tstate = state_from_jax(fused_tests._np(jstate))
    params_t = (tstats.from_jax(np.asarray(norm.mean), np.asarray(norm.std)), policy)
    with pytest.MonkeyPatch.context() as mp:
        kfinal, kdata = tlane.unroll_from_draws(tstate, params_t, *draws)
        mp.setenv("PUPPAX_FUSED_UNROLL", "on")
        mp.setattr(soa_env, "wrapped_step", lambda *a: pytest.fail("K3 lane taken"))
        tfinal, tdata = tlane.unroll_from_draws(tstate, params_t, *draws)
    close = np.testing.assert_allclose
    for name in ("observation", "next_observation", "action"):
        close(getattr(tdata, name).numpy(), getattr(jdata, name), atol=2e-4, err_msg=name)
    close(tdata.reward.numpy(), jdata.reward, atol=2e-4)
    np.testing.assert_array_equal(tdata.discount.numpy(), jdata.discount)
    np.testing.assert_array_equal(tdata.truncation.numpy(), jdata.truncation)
    close(tfinal.qpos.numpy(), jfinal.pipeline_state.qpos, atol=5e-5)
    scale = np.maximum(1.0, np.abs(jfinal.pipeline_state.qvel).max(1, keepdims=True))
    close(tfinal.qvel.numpy() / scale, jfinal.pipeline_state.qvel / scale, atol=5e-4)
    close(tfinal.obs.numpy(), jfinal.obs, atol=2e-4)
    for name in ("steps", "step", "last_contact"):
        np.testing.assert_array_equal(tfinal.info[name].numpy(), jfinal.info[name])
    for name in ("observation", "next_observation", "action", "reward"):
        torch.testing.assert_close(getattr(tdata, name), getattr(kdata, name), atol=1e-5,
                                   rtol=0, msg=name)
    assert torch.equal(tdata.discount, kdata.discount)


# ---- the g++ team bodies against the one-thread bodies ----


@pytest.fixture(scope="module")
def gxx(caps, tmp_path_factory):
    """g++ builds of team K1-K4[capsule] at their production warps and of
    the one-thread K1-K4[capsule] (1 substep), all at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated source cannot be built on the host")
    tenv = caps[1]
    s, es, L = tenv._s, tenv._es, H.EPISODE_LENGTH
    out = tmp_path_factory.mktemp("capsule_gxx")
    W = build.TEAM_WARPS
    team_bodies = {
        "K1": team.physics_step_team_body(s, 1, W["physics_step_team"]),
        "K2": team.env_step_team_body(s, es, 1, W["env_step_team"]),
        "K3": team.wrapped_step_team_body(s, es, 1, L, W["wrapped_step_team"]),
        "K4": cgen.fused_unroll_team_body(s, es, 1, L, W["fused_unroll_team"],
                                          build.K4_MLP_ROWS),
    }
    jobs = {
        ("K1", "team"): (build.PHYSICS_STEP_TEAM, team_bodies["K1"][0]),
        ("K2", "team"): (build.ENV_STEP_TEAM, team_bodies["K2"][0]),
        ("K3", "team"): (build.WRAPPED_STEP_TEAM, team_bodies["K3"][0]),
        ("K4", "team"): (build.FUSED_UNROLL_TEAM, team_bodies["K4"][0]),
        ("K1", "one"): (build.PHYSICS_STEP, cgen.physics_step_body(s, 1)),
        ("K2", "one"): (build.ENV_STEP, cgen.env_step_body(s, es, 1)),
        ("K3", "one"): (build.WRAPPED_STEP, cgen.wrapped_step_body(s, es, 1, L)),
        ("K4", "one"): (build.FUSED_UNROLL, cgen.fused_unroll_body(s, es, 1, L)),
    }
    libs = build.build_in_parallel(*[
        (lambda key=key: build.host_library(jobs[key][0], jobs[key][1],
                                            out / f"{key[0]}_{key[1]}"))
        for key in jobs])
    return dict(zip(jobs, libs)), {k: v[1] for k, v in team_bodies.items()}


def _run_host(fn, ins, out_rows, n):
    outs = [torch.empty((k, n), dtype=torch.float32) for k in out_rows]
    assert fn(*[t.data_ptr() for t in ins + outs], n) == 0
    return outs


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_team_bodies_gxx_bit_for_bit(caps, k3_inputs, gxx, kernel):
    """Each g++ team K[capsule] body against its g++ one-thread body on the
    pinned states: the same operations in the same order, bit for bit; no
    global scratch (the capsule kinds are straight-line code); team K3
    within the parity tolerances of JAX."""
    _, tenv, _ = caps
    s, es, L = tenv._s, tenv._es, H.EPISODE_LENGTH
    libs, stats = gxx
    assert "scratch_bytes_per_env" not in stats[kernel]
    assert stats[kernel]["shared_bytes"] <= team.SHARED_BUDGET
    blocks, want = k3_inputs
    team_lib, one_lib = libs[(kernel, "team")], libs[(kernel, "one")]
    if kernel == "K4":
        layers, k4 = H.fused_unroll_inputs(tenv, NB, T, "elu", L)
        got = fused_unroll.kernel_call(team_lib.fused_unroll_team_host, s, es, "elu", layers,
                                       fused_unroll.team_weights(layers), *k4)
        one = fused_unroll.kernel_call(one_lib.fused_unroll_host, s, es, "elu", layers,
                                       fused_unroll.one_thread_weights(layers), *k4)
        pairs = [(g, o) for g, o in zip(got, one) if g is not None or o is not None]
    else:
        if kernel == "K1":
            ctrl = torch.from_numpy(np.ascontiguousarray(blocks[2] * 0.3))
            ins = H.to_torch([blocks[0], blocks[1]]) + [ctrl] + H.to_torch([blocks[5]])
            rows, entry = soa.physics_block_rows(s)[1], "physics_step"
        elif kernel == "K2":
            ins, rows, entry = H.to_torch(blocks[:6]), soa_env.env_block_rows(s, es)[1], \
                "env_step"
        else:
            ins, rows, entry = H.to_torch(blocks), soa_env.block_rows(s, es)[1], "wrapped_step"
        got = _run_host(getattr(team_lib, f"{entry}_team_host"), ins, rows, NB)
        one = _run_host(getattr(one_lib, f"{entry}_host"), ins, rows, NB)
        pairs = list(zip(got, one))
    for i, (g, o) in enumerate(pairs):
        assert torch.equal(g, o), f"g++ team {kernel}[capsule] vs one-thread: output {i}"
    if kernel == "K3":
        H.assert_wrapped_outputs_close([g.numpy() for g in got], want, s, es,
                                       soa_env.aux_row_map(es), "g++ team K3[capsule] vs JAX")


# ---- float64 against puppax's narrowphase and pipeline (x64 from here on) ----


@pytest.fixture(scope="module", params=["free", "pupper"])
def scene(request, x64):
    """A capsule model in float64 in both packages: the free-capsule scene
    or the capsule Pupper."""
    xml = _free_capsules_xml() if request.param == "free" else capsule_xml()
    m = jax_load_model(None, dtype=jnp.float64, xml_string=xml).robot
    return request.param, m, H.model_from_jax(m)


def _poses(name, m, rng, n=8):
    """(n, nq) generic poses: the free scene's bodies at random heights and
    orientations (every pair near contact in some env), the Pupper's base
    low and tilted with random joint angles."""
    q = np.tile(np.asarray(m.key_qpos if name == "pupper" else m.qpos0, np.float64), (n, 1))
    if name == "free":
        for b in range(3):
            q[:, 7 * b:7 * b + 3] = rng.uniform([-0.06, -0.06, 0.0], [0.06, 0.06, 0.16], (n, 3))
            quat = rng.normal(size=(n, 4))
            q[:, 7 * b + 3:7 * b + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    else:
        q[:, 2] = rng.uniform(0.05, 0.16, n)
        quat = rng.normal(0, 1, (n, 4)) * 0.3 + np.array([1.0, 0, 0, 0])
        q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        q[:, 7:] += rng.uniform(-1.2, 1.2, (n, 12))
    return q


def test_capsule_narrowphase_matches_jax(scene):
    name, m, tm = scene
    qpos = _poses(name, m, np.random.RandomState(0))
    jkin = jax.vmap(lambda q: jsmooth.kinematics(m, q))(jnp.asarray(qpos))
    tmt = pipeline.model_tensors(tm, torch.float64, "cpu")
    kin = smooth.kinematics(tmt, torch.from_numpy(qpos))
    seen = 0
    for kind in ("plane_capsule", "sphere_capsule", "capsule_capsule"):
        pairs = getattr(m, f"pairs_{kind}")
        assert pairs, kind
        g1 = np.asarray([p[0] for p in pairs])
        g2 = np.asarray([p[1] for p in pairs])
        want = jax.vmap(lambda k: getattr(jcol, f"_{kind}")(m, k, g1, g2))(jkin)
        got = getattr(collision, f"_{kind}")(tmt, kin, g1, g2)
        for what, g, w in zip(("dist", "pos", "frame"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10, rtol=0,
                                       err_msg=f"{kind} {what}")
        seen += int((got[0] < 0.05).sum())
    assert seen >= 4


def test_capsule_pipeline_step_matches_jax(x64):
    """One substep of the capsule Pupper's pipeline (the MJX caps as they
    are) against puppax's in float64, the contact report's 36 rows in JAX's
    order. (JAX's compile of the free-capsule scene's step takes minutes:
    that scene is held at the narrowphase.)"""
    name = "pupper"
    m = jax_load_model(None, dtype=jnp.float64, xml_string=capsule_xml()).robot
    tm = H.model_from_jax(m)
    rng = np.random.default_rng(3)
    qpos = _poses(name, m, np.random.RandomState(1), n=6)
    qvel = rng.uniform(-1, 1, (6, m.nv))
    ctrl = rng.uniform(-0.5, 0.5, (6, m.nu))
    step = jax.jit(jax.vmap(lambda q, v, c: jpipe.pipeline_step(
        m, jpipe.pipeline_init(m, q, v), c, 1)))
    want = jax.tree_util.tree_map(np.asarray, step(qpos, qvel, ctrl))
    t = [torch.from_numpy(x) for x in (qpos, qvel, ctrl)]
    got = pipeline.pipeline_step(tm, pipeline.pipeline_init(tm, t[0], t[1]), t[2], 1)
    np.testing.assert_allclose(got.qpos.numpy(), want.qpos, atol=1e-10, rtol=0)
    for what, g, w in (("qvel", got.qvel, want.qvel), ("qacc", got.qacc, want.qacc)):
        scale = np.maximum(1.0, np.abs(w).max(-1, keepdims=True))
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-9, rtol=0,
                                   err_msg=what)
    np.testing.assert_allclose(got.contact_dist.numpy(), want.contact.dist, atol=1e-10)
    np.testing.assert_allclose(got.contact_pos.numpy(), want.contact.pos, atol=1e-10)
    assert got.contact_dist.shape == (6, 36) and (got.contact_dist < 0).any()
