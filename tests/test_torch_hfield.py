"""The hfield-sphere pair in the port's physics against puppax's.

* ``collision._hfield_sphere`` against ``puppax.physics.collision._hfield_sphere``
  in float64 to 1e-10 on a 16 x 16 terrain: spheres over bumps, on cell
  edges (whole-number grid coordinates), at the clip edges and off the grid;
  ``pipeline_step`` on that terrain against puppax's at the tolerances of
  ``tests/test_torch_pipeline.py``;
* the emitter's corner pick, ``soa.grid_at`` (torch rows) and the C
  back-end's ``hfield_at`` built with g++, bit for bit against the JAX
  emission's float32 one-hot fold written out here, on every cell, the
  clip edges and a NaN index;
* run9's torch-rows wrapped step (``dev/run_configs/run9_500m_hfield.json``'s
  committed tables, 1 substep) against JAX's ``wrapped_step_rows_xla`` at
  qpos 5e-5 / scaled qvel 5e-4, on states spread over the grid (some feet
  on bumps, some envs off the grid's edge), and the g++ builds of run9's
  one-thread K3 and team K3 at B = 40, bit for bit with each other and at
  those tolerances with JAX's ``wrapped_step_rows_xla``. On these states the
  g++ build and the torch rows, each within the tolerances of JAX, are not
  within them of each other in one env: its joint_acceleration term
  (-42.786 in JAX) is -42.781 built with g++ and -42.793 in torch rows, the
  host's rounding of one stiff contact state (torch's vectorized CPU math
  is not correctly rounded); on the card the kernels are bit for bit with
  the plain version (``chip_smoke.py``).
"""

import ctypes
import json
import os
import shutil
import subprocess
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.env import soa_env as jax_soa_env
from puppax.model.mjcf import load_model as jax_load_model
from puppax.physics import collision as jcol
from puppax.physics import pipeline as jpipe
from puppax.physics import smooth as jsmooth
from puppax_torch.configs import experiment as exp
from puppax_torch.env import soa_env
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.kernels import build, cgen, team
from puppax_torch.model import assets, mjcf, tables, terrain
from puppax_torch.physics import collision, pipeline, smooth, soa

torch.set_num_threads(1)

B = 6
RUN9 = os.path.join(os.path.dirname(__file__), "..", "dev", "run_configs",
                    "run9_500m_hfield.json")
N16 = 16


# ---- run9's wrapped step: torch rows against JAX, g++ K3 against torch rows ----

NB = 40  # a full 32-env group and a ragged one


@pytest.fixture(scope="module")
def run9(tmp_path_factory):
    """run9's env (1 substep), inputs spread over the grid with JAX's DR
    rows, JAX's wrapped step on them, and the g++ builds of run9's team and
    one-thread K3."""
    with open(RUN9) as f:
        cfg = exp.from_dict(json.load(f))
    tenv = PupperV3Env(device="cpu", tables=mjcf.config_tables_path(cfg.env), **H.env_kwargs(1))
    jenv = JaxEnv(path=None, xml_string=tables.config_xml(cfg.env), reward_config=get_config(),
                  **H.env_kwargs(1))
    s, es = tenv._s, tenv._es
    js, jes = jenv._cv_core._s, jenv._cv_core._es
    dr = H.jax_dr_rows(js, H.jax_dr_model(jenv, num_envs=NB), n=NB)
    rng = np.random.RandomState(0)
    blocks = H.wrapped_step_blocks(s, es, tenv.model, dr, rng, n=NB)
    blocks[0][0:2] = rng.uniform(-4.4, 4.4, (2, NB)).astype(np.float32)
    libs = None
    if shutil.which("g++") is not None:
        out = tmp_path_factory.mktemp("run9")
        W = build.TEAM_WARPS["wrapped_step_team"]
        libs = build.build_in_parallel(
            lambda: build.host_library(build.WRAPPED_STEP_TEAM, team.wrapped_step_team_body(
                s, es, 1, H.EPISODE_LENGTH, W)[0], out / "k3t"),
            lambda: build.host_library(build.WRAPPED_STEP, cgen.wrapped_step_body(
                s, es, 1, H.EPISODE_LENGTH), out / "k3"))
    want = [np.asarray(w) for w in jax_soa_env.wrapped_step_rows_xla(
        js, jes, 1, H.EPISODE_LENGTH, *[np.asarray(b) for b in blocks])]
    return tenv, want, blocks, libs


def test_run9_torch_rows_match_jax(run9):
    tenv, want, blocks, _ = run9
    s, es = tenv._s, tenv._es
    assert [p.kind for p in s.pairs].count("hs") == 8
    got = [g.numpy() for g in soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH,
                                                        *H.to_torch(blocks))]
    H.assert_wrapped_outputs_close(got, want, s, es, soa_env.aux_row_map(es),
                                   "run9 torch rows vs JAX")
    # the inputs exercise the pair: feet in contact with the terrain, and
    # envs off the grid's edge
    m = pipeline.model_tensors(tenv.model, torch.float32, "cpu")
    q = torch.from_numpy(blocks[0].T.copy())
    dist = collision.collide_pairs(m, smooth.kinematics(m, q)).dist
    kinds = np.array([p.kind for p in s.pairs])
    assert int((dist[:, kinds == "hs"] < 0).any(1).sum()) >= 5
    assert (np.abs(blocks[0][0:2]) > 4.0).any(0).sum() >= 3


def test_run9_k3_gxx_team_one_thread_and_jax(run9):
    tenv, want, blocks, libs = run9
    if libs is None:
        pytest.skip("g++ is not installed: the generated source cannot be built on the host")
    s, es = tenv._s, tenv._es
    out_rows = soa_env.block_rows(s, es)[1]

    def run(fn):
        ins = H.to_torch(blocks)
        outs = [torch.empty((k, NB), dtype=torch.float32) for k in out_rows]
        assert fn(*[t.data_ptr() for t in ins + outs], NB) == 0
        return outs

    got = run(libs[0].wrapped_step_team_host)
    one = run(libs[1].wrapped_step_host)
    for i, (g, o) in enumerate(zip(got, one)):
        assert torch.equal(g, o), f"g++ team K3 vs one-thread K3 (run9): output {i} differs"
    H.assert_wrapped_outputs_close([g.numpy() for g in got], want, s, es,
                                   soa_env.aux_row_map(es), "g++ team K3 (run9) vs JAX")


def test_hfield_variant_names_the_build():
    """run9's bodies are records of their own (``[hfield]``), keyed apart
    from the flat model's; the flat bodies keep their names."""
    with open(RUN9) as f:
        cfg = exp.from_dict(json.load(f))
    env9 = PupperV3Env.from_config(cfg.env, device="cpu")
    flat = PupperV3Env(device="cpu")
    assert build.model_variant(env9._s) == "hfield" and build.model_variant(flat._s) == ""
    assert build._statics_digest(env9._s, env9._es) != build._statics_digest(flat._s, flat._es)
    assert build.record_name(build.WRAPPED_STEP_TEAM, build.model_variant(env9._s)) == \
        "wrapped_step_team[hfield]"


def _fold(grid, iv, iu, dv, du):
    """The JAX emission's corner pick (``puppax/physics/soa.py:1334-1355``)
    in float32: per row a sum over the columns of a one-hot mask times the
    cell (a zero cell folds away), then over the rows."""
    g = np.asarray(grid, np.float32)
    nrow, ncol = g.shape
    cmask = [(iu == c).astype(np.float32) for c in range(ncol - 1)]
    rmask = [(iv == r).astype(np.float32) for r in range(nrow - 1)]
    picks = []
    for r in range(nrow):
        acc = np.zeros_like(iv)
        for c in range(ncol - 1):
            if g[r, c + du] != 0.0:
                acc = acc + cmask[c] * g[r, c + du]
        picks.append(acc)
    out = np.zeros_like(iv)
    for r in range(nrow - 1):
        out = out + rmask[r] * picks[r + dv]
    return out


def _host_lookup(grid, tmp_path):
    """``hfield_at`` of the C back-end's preamble, built with g++."""
    prog = cgen.CProgram()
    prog.grid = grid
    src = tmp_path / "lookup.cc"
    src.write_text('#include "common.cuh"\n' + prog.preamble() + 'extern "C" float at(float iv, '
                   'float iu, int dv, int du) { return hfield_at(iv, iu, dv, du); }\n')
    lib = tmp_path / "liblookup.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-I", str(build.CSRC), "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).at
    fn.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_float
    return fn


def test_grid_at_is_the_one_hot_fold(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the C lookup cannot be built on the host")
    rng = np.random.RandomState(4)
    grid64 = rng.uniform(0, 1, (7, 5)) * (rng.rand(7, 5) < 0.8)  # some zero cells
    grid = tuple(tuple(float(x) for x in row) for row in grid64)
    iv, iu = [x.ravel().astype(np.float32) for x in np.meshgrid(np.arange(6), np.arange(4))]
    c_at = _host_lookup(grid, tmp_path)
    for dv in (0, 1):
        for du in (0, 1):
            want = _fold(grid, iv, iu, dv, du)
            got = soa.grid_at(grid, torch.from_numpy(iv), torch.from_numpy(iu), dv, du).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
            c = np.array([c_at(float(a), float(b), dv, du) for a, b in zip(iv, iu)], np.float32)
            np.testing.assert_array_equal(c.view(np.int32), want.view(np.int32))
    # a NaN index reads a cell (the clipped index), in both back-ends alike
    nan = torch.tensor([float("nan")])
    assert soa.grid_at(grid, nan, nan).item() == c_at(float("nan"), float("nan"), 0, 0)


# ---- float64 against puppax's pipeline (x64 from here on: the run9 tests come first) ----


@pytest.fixture(scope="module")
def hf16(x64):
    """A 16 x 16 terrain on the bundled model, float64 in both packages."""
    tree = terrain.add_heightfield_to_model(assets.pupper_xml_tree(), N16, N16, seed=2)
    m = jax_load_model(None, dtype=jnp.float64,
                       xml_string=ET.tostring(tree.getroot(), encoding="unicode")).robot
    return m, H.model_from_jax(m)


def _points(m, rng):
    """(B, 8, 3) sphere centers: over bumps (envs 0-1), on cell edges (2),
    at the clip edges and the corners (3), off the grid (4), a cell edge in
    x at a random y (5)."""
    rx, ry = float(m.hfield_size[0]), float(m.hfield_size[1])
    nrow, ncol = m.hfield_nrow, m.hfield_ncol
    p = np.zeros((B, 8, 3))
    p[:2, :, 0] = rng.uniform(-0.9 * rx, 0.9 * rx, (2, 8))
    p[:2, :, 1] = rng.uniform(-0.9 * ry, 0.9 * ry, (2, 8))
    p[2, :, 0] = -rx + 2 * rx * rng.randint(0, ncol, 8) / (ncol - 1)
    p[2, :, 1] = -ry + 2 * ry * rng.randint(0, nrow, 8) / (nrow - 1)
    p[3, :, 0] = [rx, -rx, rx, -rx, rx, 0.3, -rx, 1.1]
    p[3, :, 1] = [ry, ry, -ry, -ry, 0.2, ry, -1.3, -ry]
    p[4, :, 0] = rng.choice([-1, 1], 8) * rng.uniform(rx + 1e-6, rx + 1.0, 8)
    p[4, :, 1] = rng.uniform(-ry - 1.0, ry + 1.0, 8)
    p[5, :, 0] = -rx + 2 * rx * rng.randint(1, ncol - 1, 8) / (ncol - 1)
    p[5, :, 1] = rng.uniform(-ry, ry, 8)
    p[..., 2] = rng.uniform(-0.01, 0.06, (B, 8))
    return p


def test_hfield_sphere_matches_jax(hf16):
    m, tm = hf16
    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(m.key_qpos, np.float64), (B, 1))
    g1 = np.asarray([p[0] for p in m.pairs_hfield_sphere])
    g2 = np.asarray([p[1] for p in m.pairs_hfield_sphere])
    centers = _points(m, rng)
    jkin = jax.vmap(lambda q: jsmooth.kinematics(m, q))(jnp.asarray(qpos))
    jkin = jkin._replace(geom_xpos=jkin.geom_xpos.at[:, g2].set(centers))
    want = jax.vmap(lambda k: jcol._hfield_sphere(m, k, g1, g2))(jkin)
    tmt = pipeline.model_tensors(tm, torch.float64, "cpu")
    kin = smooth.kinematics(tmt, torch.from_numpy(qpos))
    xpos = kin.geom_xpos.clone()
    xpos[:, g2] = torch.from_numpy(centers)
    got = collision._hfield_sphere(tmt, kin._replace(geom_xpos=xpos), g1, g2)
    for name, g, w in zip(("dist", "pos", "frame"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10, rtol=0, err_msg=name)
    dist = got[0].numpy()
    assert (dist[4] == collision._PAD_DIST).all()  # off the grid
    assert (dist[:2] < 0).any() and (dist[:2] > 0).any() and (dist[3] < 1e9).all()


def test_pipeline_step_matches_jax(hf16):
    """One substep of the pipeline (the MJX caps included) on the 16 x 16
    terrain: bases spread over the grid, low enough for feet on bumps."""
    m, tm = hf16
    rng = np.random.default_rng(3)
    qpos = np.tile(np.asarray(m.key_qpos, np.float64), (B, 1))
    qpos[:, 0:2] = rng.uniform(-3.5, 3.5, (B, 2))
    qpos[:, 2] = rng.uniform(0.12, 0.2, B)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, 12))
    qvel = rng.uniform(-1, 1, (B, 18))
    ctrl = rng.uniform(-1, 1, (B, 12))
    step = jax.jit(jax.vmap(lambda q, v, c: jpipe.pipeline_step(
        m, jpipe.pipeline_init(m, q, v), c, 1)))
    want = jax.tree_util.tree_map(np.asarray, step(qpos, qvel, ctrl))
    t = [torch.from_numpy(x) for x in (qpos, qvel, ctrl)]
    got = pipeline.pipeline_step(tm, pipeline.pipeline_init(tm, t[0], t[1]), t[2], 1)
    np.testing.assert_allclose(got.qpos.numpy(), want.qpos, atol=1e-10, rtol=0)
    for name, g, w in (("qvel", got.qvel, want.qvel), ("qacc", got.qacc, want.qacc)):
        scale = np.maximum(1.0, np.abs(w).max(-1, keepdims=True))
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-9, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(got.contact_dist.numpy(), want.contact.dist, atol=1e-10)
    np.testing.assert_allclose(got.contact_pos.numpy(), want.contact.pos, atol=1e-10)
    hs = slice(len(m.pairs_plane_sphere) + len(m.pairs_sphere_sphere), None)
    assert (got.contact_dist[:, hs] < 0).any()
