"""puppax_torch model tables and static digests against puppax.

The port carries the compiled Pupper v3 model across as data
(``puppax_torch/model/pupper_v3_tables.json``); these tests hold every
table against a fresh MuJoCo compile through ``puppax.model.load_model``,
and the emitter's static digests (``_Static``, ``_EnvStatic``) against the
JAX package's, field by field.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.model import mjcf as jax_mjcf
from puppax_torch.model import mjcf as torch_mjcf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def compiled():
    return jax_mjcf.load_model(None), torch_mjcf.load_model()


def test_tables_equal_fresh_compile(compiled):
    """Every RobotModel field of the committed tables equals a fresh
    compile: numeric leaves bit for bit, static tuples exactly."""
    jax_cm, torch_cm = compiled
    ref, got = jax_cm.robot, torch_cm.robot
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(a, np.ndarray):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", torch_mjcf.MJ_FIELDS)
def test_mj_tables_equal_mjmodel(compiled, name):
    """The float64 MjModel tables the emitter reads equal mujoco's."""
    jax_cm, torch_cm = compiled
    mj = jax_cm.mj_model
    want = mj.opt.gravity if name == "gravity" else getattr(mj, name)
    assert np.array_equal(getattr(torch_cm.mj, name), np.asarray(want, np.float64))


def test_name_maps_match_mujoco(compiled):
    import mujoco

    jax_cm, torch_cm = compiled
    mj = jax_cm.mj_model
    for i in range(mj.nbody):
        name = mj.body(i).name
        assert torch_cm.body_id(name) == mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_BODY, name)
        np.testing.assert_array_equal(
            torch_cm.body_geom_ids(name),
            mj.body(name).geomadr + np.arange(np.squeeze(mj.body(name).geomnum)),
        )
    for i in range(mj.nsite):
        name = mj.site(i).name
        assert torch_cm.site_id(name) == i


def test_tables_writer_round_trips(compiled, tmp_path):
    """``python -m puppax_torch.model.tables --write`` reproduces the
    committed file's content."""
    import json

    from puppax_torch.model import tables

    out = tables.write_tables(str(tmp_path / "t.json"))
    with open(out) as f, open(torch_mjcf.TABLES_PATH) as g:
        assert json.load(f) == json.load(g)


@pytest.fixture(scope="module")
def statics():
    jenv, tenv = H.jax_env(), H.torch_env()
    core = jenv._cv_core
    return core._s, core._es, tenv._s, tenv._es


_STATIC_FIELDS = (
    "nq", "nv", "nu", "nbody", "njnt", "nsite", "body_parentid", "body_jntid",
    "timestep", "impratio", "gravity", "qpos0", "actuator_b0", "forcerange",
    "body_pos", "body_quat", "body_iquat", "jnt_pos", "jnt_axis", "jnt_range",
    "jnt_solref", "jnt_solimp", "jnt_margin", "dof_armature", "dof_damping",
    "dof_frictionloss", "dof_solref", "dof_solimp", "dof_invweight0",
    "dof_frictional", "site_pos", "chains", "dof_body", "anc", "hess",
    "lim_joints", "dr_rows", "ndr", "npair", "cache_rows", "ncache",
)


@pytest.mark.parametrize("name", _STATIC_FIELDS)
def test_static_digest_matches(statics, name):
    js, _, ts, _ = statics
    a, b = getattr(ts, name), getattr(js, name)
    if isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), b), name
    else:
        assert a == b, name


def test_static_pairs_match(statics):
    """The 32 candidate pairs (8 plane-sphere, 24 sphere-sphere) and every
    field the emission folds from them."""
    js, _, ts, _ = statics
    assert [p.kind for p in ts.pairs] == [p.kind for p in js.pairs]
    assert sum(p.kind == "ps" for p in ts.pairs) == 8
    assert sum(p.kind == "ss" for p in ts.pairs) == 24
    for tp, jp in zip(ts.pairs, js.pairs):
        for field in tp._fields:
            assert getattr(tp, field) == getattr(jp, field), (field, tp.geom1, tp.geom2)


_ENV_FIELDS = (
    "default_pose", "action_scale", "lowers", "uppers", "Da", "Di", "dt",
    "foot_radius", "use_imu", "obs_dim", "hist", "feet_sites", "torso_body",
    "lower_leg_bodies", "cos_term", "terminal_z", "early_term",
    "resample_step", "sigma", "scales", "desired_abduction", "ss_thresh",
    "knee_pairs", "body_pairs", "env_rows", "nenv_rows", "noise_rows",
    "nnoise_rows", "out_rows", "nout_rows",
)


@pytest.mark.parametrize("name", _ENV_FIELDS)
def test_env_static_digest_matches(statics, name):
    _, jes, _, tes = statics
    assert getattr(tes, name) == getattr(jes, name), name


def test_aux_rows_and_reward_order_match(statics):
    from puppax.env import soa_env as jax_soa_env
    from puppax_torch.env import soa_env as torch_soa_env

    _, jes, _, tes = statics
    assert torch_soa_env.REWARD_ORDER == jax_soa_env.REWARD_ORDER
    assert torch_soa_env.aux_row_map(tes) == jax_soa_env.aux_row_map(jes)


def test_import_needs_no_jax_flax_or_mujoco():
    """Importing every module of ``puppax_torch`` and ``load_model()`` in a
    fresh process leave jax, flax, optax, orbax, ml_collections, mujoco,
    the JAX package ``puppax`` and the TPU probes of ``dev/`` out of
    ``sys.modules``."""
    code = (
        "import sys\n"
        "import puppax_torch\n"
        "from puppax_torch.model import load_model\n"
        "from puppax_torch import random, utils\n"
        "from puppax_torch.env import fused_unroll, pupper, rewards, rollout, wrappers\n"
        "from puppax_torch.kernels import build, cgen, team\n"
        "from puppax_torch.ops import linalg\n"
        "from puppax_torch.physics import collision, constraint, integrate, pipeline\n"
        "from puppax_torch.physics import smooth, soa, solver\n"
        "import puppax_torch.probes\n"
        "from puppax_torch.probes import common, probe_fma_fusion, probe_launch_overhead\n"
        "from puppax_torch.probes import profile_kernel_phases, profile_layout\n"
        "from puppax_torch.probes import probe_degradation, profile_boundary\n"
        "from puppax_torch.probes import profile_overhead, profile_scan\n"
        "from puppax_torch.probes import pallas_soa_probe, pallas_spd_poc, profile_team\n"
        "from puppax_torch.tools import metrics, profile_unroll, rank_scaling\n"
        "from puppax_torch.tools import eval as _eval, plotting, profiling, video\n"
        "from puppax_torch.parallel import mesh\n"
        "from puppax_torch.train import acting, checkpoint, networks, ppo\n"
        "from puppax_torch.scripts import export_policy, train\n"
        "from puppax_torch.export import native, params\n"
        "load_model()\n"
        "banned = {'jax', 'flax', 'optax', 'orbax', 'ml_collections', 'mujoco', 'puppax', 'dev'}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
