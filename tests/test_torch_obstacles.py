"""Obstacle terrain's model layer, narrowphase and pipeline in the port
against puppax's.

* ``puppax_torch/model/obstacles.py`` gives ``puppax.model.obstacles``'
  layout and XML string for the same arguments (run8's and two others);
* the tables writer (``model/tables.py --config``) compiles run8's boxes
  (``dev/run_configs/run8_500m_obstacles.json``: 20 boxes, seed 0) into the
  pair lists ``puppax.model.mjcf.load_model`` gives, the committed file is
  what it writes, and ``mjcf.config_tables_path`` names a box terrain by
  its ``obstacle*`` fields (a config without boxes keeps today's files);
* ``collision._sphere_box`` against ``puppax.physics.collision._sphere_box``
  in float64 at 1e-12 on points outside, inside, on edges and corners and
  on face ties; ``pipeline_step`` on a 3-box model against puppax's at the
  tolerances of ``tests/test_torch_pipeline.py``;
* a model with boxes and an 8 x 8 heightfield reports its contacts in
  JAX's kind order (plane-sphere, sphere-sphere, sphere-box, hfield-sphere),
  in the torch pipeline and in the emitter's K1 caches (as
  ``tests/test_soa.py::test_soa_all_pair_kinds_combined_reporting`` holds
  JAX's emission).
"""

import json
import os
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.model import assets as jassets
from puppax.model import obstacles as jobstacles
from puppax.model import terrain as jterrain
from puppax.model.mjcf import load_model as jax_load_model
from puppax.physics import collision as jcol
from puppax.physics import pipeline as jpipe
from puppax.physics import smooth as jsmooth
from puppax_torch.configs import experiment as exp
from puppax_torch.model import add_boxes_to_model, assets, mjcf, obstacles, tables, terrain
from puppax_torch.physics import collision, pipeline, smooth, soa

torch.set_num_threads(1)

RUN8 = os.path.join(os.path.dirname(__file__), "..", "dev", "run_configs",
                    "run8_500m_obstacles.json")


def _xml(tree):
    return ET.tostring(tree.getroot(), encoding="unicode")


def _run8():
    with open(RUN8) as f:
        return exp.from_dict(json.load(f))


@pytest.mark.parametrize("n, seed, xr, yr, height, length", [
    (20, 0, (-5.0, 5.0), (-5.0, 5.0), 0.02, 3.0),  # run8's
    (3, 7, (-1.0, 1.0), (-1.0, 1.0), 0.02, 3.0),
    (9, 123, (-2.0, 4.0), (-3.0, 1.5), 0.05, 1.25),
])
def test_layout_and_xml_equal_jax(n, seed, xr, yr, height, length):
    assert obstacles.sample_box_layout(n, xr, yr, seed) == \
        jobstacles.sample_box_layout(n, xr, yr, seed)
    for yaw in (0.0, 1.3, -2.9):
        assert obstacles.yaw_quat(yaw) == jobstacles.yaw_quat(yaw)
    got = add_boxes_to_model(assets.pupper_xml_tree(), n, xr, yr, height=height, length=length,
                             seed=seed)
    want = jobstacles.add_boxes_to_model(jassets.pupper_xml_tree(), n, xr, yr, height=height,
                                         length=length, seed=seed)
    assert _xml(got) == _xml(want)


def test_run8_tables_equal_a_fresh_write_and_jax_pairs(tmp_path):
    """The committed run8 tables are what ``tables.py --config`` writes,
    byte for byte; their pair lists (box by box: each of the 8 spheres with
    box 0, then with box 1, ...) are ``puppax.model.mjcf.load_model``'s,
    and the flat model's tables are still the bundled file."""
    cfg = _run8()
    out = tmp_path / "run8.json"
    tables.write_config_tables(cfg.env, str(out))
    path = mjcf.config_tables_path(cfg.env)
    with open(path, "rb") as f:
        assert out.read_bytes() == f.read()
    got = mjcf.load_model(path).robot
    want = jax_load_model(None, xml_string=tables.config_xml(cfg.env)).robot
    for name in ("pairs_plane_sphere", "pairs_sphere_sphere", "pairs_sphere_box",
                 "pairs_hfield_sphere", "geom_bodyid", "geom_type"):
        assert tuple(map(tuple, np.atleast_2d(getattr(got, name)))) == \
            tuple(map(tuple, np.atleast_2d(np.asarray(getattr(want, name))))), name
    assert len(got.pairs_sphere_box) == 160
    np.testing.assert_array_equal(got.geom_size, np.asarray(want.geom_size))
    np.testing.assert_array_equal(got.geom_friction, np.asarray(want.geom_friction))
    flat = tmp_path / "flat.json"
    tables.write_tables(str(flat))
    with open(mjcf.TABLES_PATH, "rb") as f:
        assert flat.read_bytes() == f.read()


def test_config_tables_path_names_the_boxes():
    """A box terrain's tables are named by its ``obstacle*`` fields, boxes
    before a heightfield; a config without boxes keeps today's names."""
    cfg = _run8().env
    path = mjcf.config_tables_path(cfg)
    assert os.path.basename(path).startswith("pupper_v3_boxes_") and os.path.exists(path)
    assert mjcf.tables_path(exp.EnvConfig()) == mjcf.TABLES_PATH
    assert os.path.basename(mjcf.tables_path(exp.EnvConfig(heightfield=True))) == \
        "pupper_v3_hfield_f9d29eacc821_tables.json"
    both = os.path.basename(mjcf.tables_path(exp.EnvConfig(n_obstacles=20, heightfield=True)))
    assert both.startswith("pupper_v3_boxes_") and "_hfield_f9d29eacc821_" in both
    other = exp.EnvConfig(n_obstacles=20, obstacle_seed=1)
    assert mjcf.tables_path(other) != path
    with pytest.raises(FileNotFoundError, match="python -m puppax_torch.model.tables --config"):
        mjcf.config_tables_path(other)


# ---- float64 against puppax's narrowphase and pipeline ----


@pytest.fixture(scope="module")
def boxes3(x64):
    """3 boxes within a metre of the origin on the bundled model, float64
    in both packages."""
    tree = obstacles.add_boxes_to_model(assets.pupper_xml_tree(), 3, (-1.0, 1.0), (-1.0, 1.0),
                                        seed=4)
    m = jax_load_model(None, dtype=jnp.float64, xml_string=_xml(tree)).robot
    return m, H.model_from_jax(m)


# the envs whose boxes are turned to the world's axes: there a point's
# box-frame coordinates are exact in both packages, so its face ties and
# its zero coordinates are the same ties in both
AXIS_ENVS = (2, 3, 4)


def _box_points(m, rng):
    """(6, 24, 3) sphere centers against the boxes of the 24 pairs (box by
    box): outside by a face, an edge or a corner (env 0), inside (1), on
    the surface and on its edges (2), at face ties, the center and a
    corner of the box (3), on a face's plane inside (4), random near the
    box (5). Built in each pair's box frame, then posed in the world (the
    boxes of ``AXIS_ENVS`` unturned)."""
    half = np.asarray(m.geom_size)[[b for _, b in m.pairs_sphere_box]]  # (24, 3)
    k = len(m.pairs_sphere_box)
    loc = np.zeros((6, k, 3))
    sgn = rng.choice([-1.0, 1.0], (6, k, 3))
    out = rng.rand(k, 3) < 0.7
    out[~out.any(1), 0] = True  # a point on a turned box's surface has no normal to hold
    loc[0] = sgn[0] * half * (1.0 + rng.uniform(0.05, 2.0, (k, 3)) * out)
    loc[1] = sgn[1] * half * rng.uniform(0.0, 0.95, (k, 3))
    loc[2] = sgn[2] * half * np.where(rng.rand(k, 3) < 0.5, 1.0, rng.uniform(0, 1, (k, 3)))
    # ties: two or three equal gaps (a cube-like corner region), the center
    cube = half.min(1, keepdims=True)
    loc[3] = sgn[3] * (half - 0.5 * cube)
    loc[3, ::3] = 0.0
    loc[4] = sgn[4] * half * rng.uniform(0.0, 0.9, (k, 3))
    loc[4, :, 0] = 0.0  # on the plane x = 0 of the box frame: psel may be 0
    loc[5] = sgn[5] * half * rng.uniform(0.0, 1.5, (k, 3))
    world = np.zeros_like(loc)
    for i, (_, b) in enumerate(m.pairs_sphere_box):
        R = soa._quat_mat_np(np.asarray(m.geom_quat)[b])
        world[:, i] = np.asarray(m.geom_pos)[b] + loc[:, i] @ R.T
        world[AXIS_ENVS, i] = np.asarray(m.geom_pos)[b] + loc[AXIS_ENVS, i]
    return world


def test_sphere_box_matches_jax(boxes3):
    m, tm = boxes3
    rng = np.random.RandomState(0)
    B = 6
    qpos = np.tile(np.asarray(m.key_qpos, np.float64), (B, 1))
    g1 = np.asarray([p[0] for p in m.pairs_sphere_box])
    g2 = np.asarray([p[1] for p in m.pairs_sphere_box])
    centers = _box_points(m, rng)
    jkin = jax.vmap(lambda q: jsmooth.kinematics(m, q))(jnp.asarray(qpos))
    tmt = pipeline.model_tensors(tm, torch.float64, "cpu")
    kin = smooth.kinematics(tmt, torch.from_numpy(qpos))
    xmat = kin.geom_xmat.clone()
    for e in AXIS_ENVS:
        xmat[e, np.unique(g2)] = torch.eye(3, dtype=torch.float64)
    kin = kin._replace(geom_xmat=xmat)
    jkin = jkin._replace(geom_xmat=jnp.asarray(xmat.numpy()))
    want, got = [], []
    # a box's pairs have distinct spheres: one call per box, its spheres moved
    for box in np.unique(g2):
        i = np.flatnonzero(g2 == box)
        jk = jkin._replace(geom_xpos=jkin.geom_xpos.at[:, g1[i]].set(centers[:, i]))
        want.append(jax.vmap(lambda k: jcol._sphere_box(m, k, g1[i], g2[i]))(jk))
        xpos = kin.geom_xpos.clone()
        xpos[:, g1[i]] = torch.from_numpy(centers[:, i])
        got.append(collision._sphere_box(tmt, kin._replace(geom_xpos=xpos), g1[i], g2[i]))
    for f, name in enumerate(("dist", "pos", "frame")):
        g = np.concatenate([x[f].numpy() for x in got], 1)
        w = np.concatenate([np.asarray(x[f]) for x in want], 1)
        np.testing.assert_allclose(g, w, atol=1e-12, rtol=0, err_msg=name)
    dist = np.concatenate([x[0].numpy() for x in got], 1)
    assert (dist[1] < 0).all() and (dist[0] > 0).any()


def test_pipeline_step_matches_jax(boxes3):
    """One substep of the pipeline (the MJX caps included) with feet on the
    boxes: bases searched over the 2 m square until a sphere penetrates a
    box."""
    m, tm = boxes3
    rng = np.random.default_rng(3)
    B = 6
    tmt = pipeline.model_tensors(tm, torch.float64, "cpu")
    kinds = np.array(["ps"] * len(m.pairs_plane_sphere) + ["ss"] * len(m.pairs_sphere_sphere)
                     + ["bs"] * len(m.pairs_sphere_box))
    qpos = np.tile(np.asarray(m.key_qpos, np.float64), (B, 1))
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, 12))
    for e in range(B):
        cand = np.repeat(qpos[e:e + 1], 1024, 0)
        cand[:, 0:2] = rng.uniform(-1.0, 1.0, (1024, 2))
        cand[:, 2] = rng.uniform(0.1, 0.16, 1024)
        d = collision.collide_pairs(tmt, smooth.kinematics(tmt, torch.from_numpy(cand))).dist
        hit = np.flatnonzero((d[:, kinds == "bs"] < 0).any(1).numpy())
        qpos[e] = cand[hit[0] if len(hit) and e % 3 != 2 else 0]
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
    init = pipeline.pipeline_init(tm, t[0], t[1])
    assert int((init.contact_dist[:, kinds == "bs"] < 0).any(1).sum()) >= 3


def test_boxes_and_hfield_report_in_jax_kind_order():
    """A model with 3 boxes and an 8 x 8 heightfield: the pair kinds come
    plane-sphere, sphere-sphere, sphere-box, hfield-sphere in the tables,
    the torch pipeline's report and the emitter's (K1's plain version's
    contact caches), and the distances agree with JAX's pipeline."""
    tree = obstacles.add_boxes_to_model(assets.pupper_xml_tree(), 3, (-1.0, 1.0), (-1.0, 1.0))
    tree = terrain.add_heightfield_to_model(tree, nrow=8, ncol=8, seed=3)
    jtree = jobstacles.add_boxes_to_model(jassets.pupper_xml_tree(), 3, (-1.0, 1.0), (-1.0, 1.0))
    jtree = jterrain.add_heightfield_to_model(jtree, nrow=8, ncol=8, seed=3)
    assert _xml(tree) == _xml(jtree)
    jm = jax_load_model(None, xml_string=_xml(jtree)).robot.tree_replace(
        {"opt.timestep": H.PHYSICS_DT})
    import mujoco

    cm = tables.tables_from_mjmodel(mujoco.MjModel.from_xml_string(_xml(tree)))
    tm = H.model_from_jax(jm)
    assert [list(map(list, getattr(tm, k))) for k in ("pairs_sphere_box", "pairs_hfield_sphere")] \
        == [cm["robot"][k] for k in ("pairs_sphere_box", "pairs_hfield_sphere")]
    s = soa._Static(tm)
    kinds = [p.kind for p in s.pairs]
    order = {"ps": 0, "ss": 1, "bs": 2, "hs": 3}
    assert kinds == sorted(kinds, key=order.get) and set(kinds) == set(order)
    B = 6
    rng = np.random.RandomState(9)
    qpos, qvel, ctrl = H.random_states(tm, rng, B)
    qpos = H.place_over_boxes(tm, qpos, rng, range(0, B, 2))
    assert H.box_contacts(tm, qpos).sum() >= 2
    ref = jax.jit(jax.vmap(lambda q, v, c: jpipe.pipeline_step(
        jm, jpipe._zeros_state(jm, q, v), c, 1).contact.dist))(qpos, qvel, ctrl)
    dr = soa.dr_rows_block(s, soa.dr_inputs(tm, s, B))
    _, _, caches = soa.physics_step_rows(s, 1, *[torch.from_numpy(x.T.copy())
                                                 for x in (qpos, qvel, ctrl)], dr)
    r0, n = s.cache_rows["con_dist"]
    np.testing.assert_allclose(caches[r0:r0 + n].numpy().T, np.asarray(ref), atol=5e-5)
    tmt = pipeline.model_tensors(tm, torch.float32, "cpu")
    got = pipeline.pipeline_step(tmt, pipeline._zeros_state(tmt, *[torch.from_numpy(x) for x in (
        qpos, qvel)]), torch.from_numpy(ctrl), 1).contact_dist
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)
