"""Heightfield terrain's model layer in the port against puppax's.

The XML surgery (``puppax_torch/model/surgery.py``, ``terrain.py``) gives
the JAX package's XML string for the same arguments; the tables writer
(``model/tables.py``) compiles run9's terrain
(``dev/run_configs/run9_500m_hfield.json``) into the pair lists and the
grid ``puppax.model.mjcf.load_model`` gives, and the committed tables are
what the writer writes; ``mjcf.config_tables_path`` finds them, and raises
for a terrain or another MJCF without them, naming the writer; the writer
files the capsule pairs and raises for the pair kinds the JAX package
refuses; the env of run9's config resets and steps.
"""

import dataclasses
import json
import os
import xml.etree.ElementTree as ET

import mujoco
import numpy as np
import pytest
import torch

from puppax.model import assets as jassets
from puppax.model import obstacles as jobstacles
from puppax.model import surgery as jsurgery
from puppax.model import terrain as jterrain
from puppax.model.mjcf import load_model as jax_load_model
from puppax_torch import random
from puppax_torch.configs import experiment as exp
from puppax_torch.env.domain_randomization import domain_randomize
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.model import assets, mjcf, surgery, tables, terrain
from puppax_torch.physics import soa

torch.set_num_threads(1)

RUN9 = os.path.join(os.path.dirname(__file__), "..", "dev", "run_configs",
                    "run9_500m_hfield.json")


def _xml(tree):
    return ET.tostring(tree.getroot(), encoding="unicode")


def _run9():
    with open(RUN9) as f:
        return exp.from_dict(json.load(f))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("shape", [(32, 32), (17, 9)])
def test_heights_and_xml_equal_jax(seed, shape):
    nrow, ncol = shape
    np.testing.assert_array_equal(terrain.generate_heights(nrow, ncol, seed=seed),
                                  jterrain.generate_heights(nrow, ncol, seed=seed))
    size = (3.0, 2.5, 0.05, 0.02)
    got = terrain.add_heightfield_to_model(assets.pupper_xml_tree(), nrow, ncol, size,
                                           seed=seed)
    want = jterrain.add_heightfield_to_model(jassets.pupper_xml_tree(), nrow, ncol, size,
                                             seed=seed)
    assert _xml(got) == _xml(want)


def test_run9_config_hash_equals_jax():
    """run9's config, and with ``--set env.heightfield=true`` on the
    default, hashes as in the JAX package's CLI."""
    from puppax.configs import experiment as jexp

    with open(RUN9) as f:
        data = json.load(f)
    assert exp.config_hash(exp.from_dict(data)) == jexp.config_hash(jexp.from_dict(data))
    over = {"env.heightfield": True}
    assert exp.config_hash(exp.apply_overrides(exp.ExperimentConfig(), over)) == \
        jexp.config_hash(jexp.apply_overrides(jexp.ExperimentConfig(), over))


def test_surgery_equals_jax():
    assert assets.pupper_xml() == jassets.pupper_xml()
    got = surgery.set_mjx_custom_options(assets.pupper_xml_tree(), 9, 7)
    assert _xml(got) == _xml(jsurgery.set_mjx_custom_options(jassets.pupper_xml_tree(), 9, 7))
    bare = "<mujoco><worldbody/></mujoco>"
    assert surgery.set_mjx_custom_options(ET.ElementTree(ET.fromstring(bare)), 5, 4) is None
    for quat in (None, [0.0, 0.0, 0.0, 1.0]):
        got = surgery.set_robot_starting_position(assets.pupper_xml_tree(), [1.0, 2.0, 0.3],
                                                  quat)
        want = jsurgery.set_robot_starting_position(jassets.pupper_xml_tree(), [1.0, 2.0, 0.3],
                                                    quat)
        assert _xml(got) == _xml(want)


def test_run9_tables_equal_jax_model():
    """The committed run9 tables against puppax's compile of the same XML:
    the pair lists, the grid bit for bit in float32, its size."""
    cfg = _run9()
    xml = tables.config_xml(cfg.env)
    want = jax_load_model(None, xml_string=xml).robot
    got = mjcf.load_model(mjcf.config_tables_path(cfg.env)).robot
    for name in ("pairs_plane_sphere", "pairs_sphere_sphere", "pairs_hfield_sphere",
                 "pairs_sphere_box", "hfield_nrow", "hfield_ncol", "ngeom", "geom_bodyid"):
        assert getattr(got, name) == getattr(want, name), name
    assert len(got.pairs_hfield_sphere) == 8 and got.hfield_data.shape == (32, 32)
    assert got.hfield_data.dtype == np.float32
    np.testing.assert_array_equal(got.hfield_data, np.asarray(want.hfield_data))
    np.testing.assert_array_equal(got.hfield_size, np.asarray(want.hfield_size))
    np.testing.assert_array_equal(got.geom_friction, np.asarray(want.geom_friction))
    assert int((got.hfield_data != 0).sum()) == 1019


def test_config_write_equals_committed(tmp_path):
    """A fresh ``tables.py --config`` write of run9 is the committed file,
    byte for byte; the flat model's --write is the bundled file."""
    cfg = _run9()
    out = tmp_path / "run9.json"
    tables.write_config_tables(cfg.env, str(out))
    with open(mjcf.config_tables_path(cfg.env), "rb") as f:
        assert out.read_bytes() == f.read()
    flat = tmp_path / "flat.json"
    tables.write_tables(str(flat))
    with open(mjcf.TABLES_PATH, "rb") as f:
        assert flat.read_bytes() == f.read()


def test_config_tables_path_raises_without_tables(tmp_path):
    cfg = _run9().env
    assert mjcf.config_tables_path(exp.EnvConfig()) == mjcf.TABLES_PATH
    assert "f9d29eacc821" in mjcf.config_tables_path(cfg)
    other = exp.apply_overrides(exp.ExperimentConfig(env=cfg),
                                {"env.heightfield_seed": 7}).env
    with pytest.raises(FileNotFoundError, match="python -m puppax_torch.model.tables --config"):
        mjcf.config_tables_path(other)
    with pytest.raises(FileNotFoundError, match="python -m puppax_torch.model.tables --config"):
        mjcf.config_tables_path(exp.EnvConfig(n_obstacles=3))  # boxes without committed tables
    # another MJCF without committed tables (the bundled model with a heavier
    # torso), alone and under a terrain: the writer's command is named
    tree = jassets.pupper_xml_tree()
    tree.getroot().find(".//body/inertial").set("mass", "1.5")
    robot = tmp_path / "robot.xml"
    robot.write_text(_xml(tree))
    writer = "python -m puppax_torch.model.tables --set env.path="
    with pytest.raises(FileNotFoundError, match=writer):
        mjcf.config_tables_path(exp.EnvConfig(path=str(robot)))
    with pytest.raises(FileNotFoundError, match=writer):
        PupperV3Env(path=str(robot), device="cpu")
    with pytest.raises(FileNotFoundError, match="--config <config.json> --set env.path="):
        mjcf.config_tables_path(dataclasses.replace(cfg, path=str(robot)))


def test_writer_raises_for_unported_pairs():
    """The writer files a model with capsule pairs (the feet as capsules,
    ``bench.py``'s variant: ``test_torch_capsule.py``) and boxes
    (``test_torch_obstacles.py``), and refuses what the JAX package refuses:
    a geom type outside its pair kinds (a cylinder foot)."""
    tree = jassets.pupper_xml_tree()
    for geom in tree.getroot().iter("geom"):
        if geom.get("type") == "sphere" and geom.get("size") == "0.01995":
            geom.set("type", "capsule")
            geom.set("size", "0.015 0.02")
    robot = tables.tables_from_mjmodel(mujoco.MjModel.from_xml_string(_xml(tree)))["robot"]
    assert [len(robot[f"pairs_{k}"]) for k in ("plane_capsule", "sphere_capsule",
                                                "capsule_capsule")] == [4, 12, 6]
    for geom in tree.getroot().iter("geom"):
        if geom.get("type") == "capsule":
            geom.set("type", "cylinder")
    with pytest.raises(NotImplementedError, match="unsupported"):
        tables.tables_from_mjmodel(mujoco.MjModel.from_xml_string(_xml(tree)))
    boxes = jobstacles.add_boxes_to_model(jassets.pupper_xml_tree(), 2, (-1, 1), (-1, 1), seed=0)
    assert len(tables.tables_from_mjmodel(mujoco.MjModel.from_xml_string(
        _xml(boxes)))["robot"]["pairs_sphere_box"]) == 16


def test_dr_friction_covers_the_hfield_pairs():
    """DR's one friction scalar reaches every pair, the hfield's too, so
    the privileged-friction contract (``pair_mu[0] == geom_friction[0, 0]``)
    holds on run9's terrain."""
    cfg = dataclasses.replace(_run9().env, privileged_obs=True)
    env = PupperV3Env.from_config(cfg, device="cpu")
    assert env._es.priv
    m = domain_randomize(env.model, random.split(random.key(1), 6))
    mu = soa.dr_inputs(m, env._s, 6)["pair_mu"]
    assert [p.kind for p in env._s.pairs].count("hs") == 8
    assert torch.equal(mu, m.geom_friction[:, :1, 0].expand(-1, env._s.npair))


def test_env_from_run9_config_steps():
    """The counterpart of ``tests/test_terrain.py::test_env_runs_on_heightfield_terrain``:
    run9's env from its committed tables, reset and 25 zero-action steps
    (one physics substep each), everything finite."""
    cfg = exp.apply_overrides(_run9(), {"env.environment_timestep": 0.004}).env
    env = PupperV3Env.from_config(cfg, device="cpu")
    assert [p.kind for p in env._s.pairs].count("hs") == 8
    assert env.model.hfield_data.shape == (32, 32)
    state = env.reset(random.split(random.key(0), 4))
    for _ in range(25):
        state = env.step(state, torch.zeros((4, env.action_size)))
    assert torch.isfinite(state.obs).all() and torch.isfinite(state.reward).all()
    assert torch.isfinite(state.pipeline_state.qpos).all()
