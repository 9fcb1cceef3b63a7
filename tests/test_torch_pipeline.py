"""The port's MuJoCo-semantics physics pipeline against puppax's, in float64.

``puppax_torch.physics`` (``smooth``, ``collision``, ``constraint``,
``solver``, ``integrate``, ``pipeline``, batched over envs) against
``puppax.physics`` (per env, vmapped and jitted) on the same numpy-seeded
states, shaped like ``tests/test_physics_oracle.py:33-42``: random base
poses and orientations (many contacts, the MJX caps active), joints
around the default pose, one env past a joint limit. Both compute the same
algorithm in float64, so only the order of sums differs: kinematics,
inertias, forces and the physics caches agree within 1e-10 absolute; qacc
and qvel within 1e-9 scaled by max(1, the env's largest magnitude), as
``test_physics_oracle.py:86-87`` scales them; the constraint rows and the
contacts within 1e-10 absolute plus 1e-10 relative (D and R reach 1e7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env.domain_randomization import domain_randomize
from puppax.model.mjcf import load_model as jax_load_model
from puppax.ops import linalg as jlinalg
from puppax.physics import collision as jcol
from puppax.physics import constraint as jcon
from puppax.physics import pipeline as jpipe
from puppax.physics import smooth as jsmooth
from puppax.physics import solver as jsolver
from puppax_torch.ops import linalg
from puppax_torch.physics import collision, constraint, pipeline, smooth, solver

torch.set_num_threads(1)

B = 8
DEFAULT_POSE = [0.26, 0.0, -0.52, -0.26, 0.0, 0.52, 0.26, 0.0, -0.52, -0.26, 0.0, 0.52]
ATOL = 1e-10


def _states(m, seed: int = 0):
    """B states as test_physics_oracle._rand_state makes them; env 0 is
    airborne with its first hip past the upper joint limit, env 1 upright
    and sunk to 4 cm, where all 8 plane-sphere pairs penetrate (the caps
    keep 4 of them, then 5 contacts in all)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.key_qpos, np.float64), (B, 1))
    qpos[:, 0:2] = rng.uniform(-0.5, 0.5, (B, 2))
    qpos[:, 2] = rng.uniform(0.1, 0.3, B)
    quat = rng.normal(size=(B, 4))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] = np.array(DEFAULT_POSE) + rng.uniform(-0.3, 0.3, (B, 12))
    qpos[0, 2], qpos[0, 3:7], qpos[0, 7:] = 0.5, [1.0, 0.0, 0.0, 0.0], DEFAULT_POSE
    qpos[0, 7] = 2.6  # beyond the upper limit 2.51
    qpos[1, 2], qpos[1, 3:7] = 0.04, [1.0, 0.0, 0.0, 0.0]
    qvel = rng.uniform(-2, 2, (B, 18))
    ctrl = rng.uniform(-1, 1, (B, 12))
    return qpos, qvel, ctrl


def _stages_jax(m, qpos, qvel, ctrl):
    """Every stage of puppax's forward pass for one env."""
    kin = jsmooth.kinematics(m, qpos)
    com = jsmooth.com_pos(m, kin)
    vel = jsmooth.com_vel(m, com, qvel)
    qM = jsmooth.crb(m, com)
    bias = jsmooth.rne(m, com, vel, qvel)
    passive = jsmooth.passive(m, qvel)
    act = jsmooth.actuation(m, qpos, qvel, ctrl)
    qacc_smooth = jlinalg.spd_solve(qM, passive + act - bias)
    con = jcol.collide(m, kin)
    efc = jcon.make_efc(m, com, qpos, qvel, con)
    res = jsolver.solve(m, qM, qacc_smooth, efc)
    return dict(kin=kin, com=com, vel=vel, qM=qM, bias=bias, passive=passive, act=act,
                qacc_smooth=qacc_smooth, con=con, pairs=jcol.collide_pairs(m, kin), efc=efc,
                res=res)


def _stages_torch(m, qpos, qvel, ctrl):
    t = [torch.from_numpy(np.asarray(x, np.float64)) for x in (qpos, qvel, ctrl)]
    qpos, qvel, ctrl = t
    m = pipeline.model_tensors(m, torch.float64, "cpu")
    kin = smooth.kinematics(m, qpos)
    com = smooth.com_pos(m, kin)
    vel = smooth.com_vel(m, com, qvel)
    qM = smooth.crb(m, com)
    bias = smooth.rne(m, com, vel, qvel)
    passive = smooth.passive(m, qvel)
    act = smooth.actuation(m, qpos, qvel, ctrl)
    qacc_smooth = linalg.spd_solve(qM, passive + act - bias)
    con = collision.collide(m, kin)
    efc = constraint.make_efc(m, com, qpos, qvel, con)
    res = solver.solve(m, qM, qacc_smooth, efc)
    return dict(kin=kin, com=com, vel=vel, qM=qM, bias=bias, passive=passive, act=act,
                qacc_smooth=qacc_smooth, con=con, pairs=collision.collide_pairs(m, kin), efc=efc,
                res=res)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models(x64):
    m = jax_load_model(None, dtype=jnp.float64).robot
    return m, H.model_from_jax(m)


@pytest.fixture(scope="module")
def stages(models):
    """Both packages' stages on the same states (one jit of puppax's)."""
    m, tm = models
    qpos, qvel, ctrl = _states(m)
    want = _np(jax.jit(jax.vmap(lambda *a: _stages_jax(m, *a)))(qpos, qvel, ctrl))
    return _stages_torch(tm, qpos, qvel, ctrl), want, (qpos, qvel, ctrl)


def _close(got, want, what, atol=ATOL, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


def _close_scaled(got, want, what, tol=1e-9):
    want = np.asarray(want)
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    _close(got / torch.from_numpy(scale), want / scale, what, atol=tol)


def test_model_from_jax_keeps_float64(models):
    m, tm = models
    assert tm.body_mass.dtype == np.float64 and tm.nbody == m.nbody
    np.testing.assert_array_equal(tm.geom_friction, np.asarray(m.geom_friction))


@pytest.mark.parametrize("name", ["kinematics", "com_pos", "com_vel"])
def test_smooth_stages_match(stages, name):
    got, want, _ = stages
    key = {"kinematics": "kin", "com_pos": "com", "com_vel": "vel"}[name]
    for field in got[key]._fields:
        _close(getattr(got[key], field), getattr(want[key], field), f"{name}.{field}")


@pytest.mark.parametrize("name", ["qM", "bias", "passive", "act"])
def test_crb_rne_passive_actuation_match(stages, name):
    got, want, _ = stages
    _close(got[name], want[name], name)


def test_qacc_smooth_matches(stages):
    got, want, _ = stages
    _close_scaled(got["qacc_smooth"], want["qacc_smooth"], "qacc_smooth")


@pytest.mark.parametrize("which", ["collide", "collide_pairs"])
def test_contacts_match(stages, which):
    """The capped solver set (top 4 per kind, then top 5) and the uncapped
    report: the same contacts in the same order, ids exactly."""
    got, want, _ = stages
    key = "con" if which == "collide" else "pairs"
    for field in got[key]._fields:
        g, w = getattr(got[key], field), getattr(want[key], field)
        if field.startswith(("geom", "body")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{which}.{field}")
        else:
            _close(g, w, f"{which}.{field}", rtol=1e-10)
    if which == "collide":
        # the caps bind on these states: more penetrating pairs than rows
        assert ((want["pairs"].dist < 0).sum(1) > want["con"].dist.shape[1]).any()


def test_make_efc_matches(stages):
    got, want, _ = stages
    for field in got["efc"]._fields:
        g, w = getattr(got["efc"], field), getattr(want["efc"], field)
        if field == "is_friction":
            np.testing.assert_array_equal(g.numpy(), w[0])
        else:
            _close(g, w, f"efc.{field}", rtol=1e-10)
    # env 0's limit row is active (a joint past its range), and contacts are
    nfl = len(got["efc"].is_friction.nonzero())
    D_lim = want["efc"].D[:, nfl : nfl + 12]
    assert (D_lim[0] > 0).any() and (want["efc"].D[:, nfl + 12 :] > 0).any()


def test_solve_matches(stages):
    got, want, _ = stages
    _close_scaled(got["res"].qacc, want["res"].qacc, "qacc")
    _close(got["res"].efc_force, want["res"].efc_force, "efc_force", rtol=1e-9)
    _close_scaled(got["res"].qfrc_constraint, want["res"].qfrc_constraint, "qfrc_constraint")


def test_forward_matches(stages, models):
    """``pipeline.forward`` end to end equals the stage chain's result."""
    _, tm = models
    got, want, (qpos, qvel, ctrl) = stages
    t = [torch.from_numpy(x) for x in (qpos, qvel, ctrl)]
    qacc, caches = pipeline.forward(pipeline.model_tensors(tm, torch.float64, "cpu"), *t)
    _close_scaled(qacc, want["res"].qacc, "forward qacc")
    assert torch.equal(qacc, got["res"].qacc)


def _ps_jax(ps):
    """puppax's PhysicsState as the port's field names."""
    return dict(qpos=ps.qpos, qvel=ps.qvel, qacc=ps.qacc, x_pos=ps.x_pos, x_rot=ps.x_rot,
                xd_vel=ps.xd_vel, xd_ang=ps.xd_ang, xpos=ps.xpos, site_xpos=ps.site_xpos,
                qfrc_actuator=ps.qfrc_actuator, contact_dist=ps.contact.dist,
                contact_pos=ps.contact.pos)


def _check_state(got, want, what):
    for name, w in _ps_jax(want).items():
        g = getattr(got, name)
        if name in ("qvel", "qacc", "xd_vel", "xd_ang", "qfrc_actuator"):
            _close_scaled(g.reshape(B, -1), np.asarray(w).reshape(B, -1), f"{what} {name}")
        else:
            _close(g, w, f"{what} {name}")


@pytest.fixture(scope="module")
def steps(models):
    """puppax's pipeline_init, and pipeline_step at 1 and 5 substeps, of a
    domain-randomized model (six leaves with a leading env axis) on the
    states of ``_states(seed=1)``. Returns the JAX results, the states and
    the port's DR model."""
    m, _ = models
    mdr, in_axes = domain_randomize(m, jax.random.split(jax.random.PRNGKey(7), B))
    qpos, qvel, ctrl = _states(m, seed=1)

    # two jits: pipeline_init, and one substep, run 5 times for 5 substeps
    # (the same forward + Euler passes as pipeline_step(n=5))
    init = jax.jit(jax.vmap(jpipe.pipeline_init, in_axes=(in_axes, 0, 0)))
    step1 = jax.jit(jax.vmap(lambda mm, st, c: jpipe.pipeline_step(mm, st, c, 1),
                             in_axes=(in_axes, 0, 0)))
    s0 = init(mdr, qpos, qvel)
    one = five = step1(mdr, s0, ctrl)
    for _ in range(4):
        five = step1(mdr, five, ctrl)
    want = _np((s0, one, five))
    return want, (qpos, qvel, ctrl), H.model_from_jax(mdr)


def test_pipeline_init_matches(steps):
    (init, _, _), (qpos, qvel, _), tmdr = steps
    got = pipeline.pipeline_init(tmdr, torch.from_numpy(qpos), torch.from_numpy(qvel))
    _check_state(got, init, "pipeline_init")


@pytest.mark.parametrize("n_substeps", [1, 5])
def test_pipeline_step_matches(steps, n_substeps):
    (init, one, five), (qpos, qvel, ctrl), tmdr = steps
    s0 = pipeline.pipeline_init(tmdr, torch.from_numpy(qpos), torch.from_numpy(qvel))
    got = pipeline.pipeline_step(tmdr, s0, torch.from_numpy(ctrl), n_substeps)
    _check_state(got, one if n_substeps == 1 else five, f"pipeline_step n={n_substeps}")


def test_dr_batched_model_is_read(steps, models):
    """The DR leaves carry a leading env axis and change the physics: the
    nominal model's step differs from the DR batch's (which matches
    puppax's above)."""
    (_, _, five), (qpos, qvel, ctrl), tmdr = steps
    assert tmdr.body_mass.shape == (B, models[1].nbody)
    assert tmdr.geom_friction.shape == (B,) + models[1].geom_friction.shape
    t = [torch.from_numpy(x) for x in (qpos, qvel, ctrl)]
    nominal = pipeline.pipeline_step(models[1], pipeline.pipeline_init(models[1], t[0], t[1]),
                                     t[2], 5)
    assert np.abs(nominal.qvel.numpy() - five.qvel).max() > 1e-3


# Newton iterations 3 with a tolerance between the improvements of the
# envs: after the first step some envs stop (improvement under the
# tolerance), the others step on.
ITER3_TOLERANCE = 1e-4


def test_multi_iteration_early_exit_matches(models):
    m, tm = models
    m3 = m.replace(solver_iterations=3, tolerance=ITER3_TOLERANCE)
    tm3 = tm.replace(solver_iterations=3, tolerance=ITER3_TOLERANCE)
    qpos, qvel, ctrl = _states(m, seed=2)
    want = np.asarray(jax.jit(jax.vmap(lambda *a: jpipe.forward(m3, *a)[0]))(qpos, qvel, ctrl))
    t = [torch.from_numpy(x) for x in (qpos, qvel, ctrl)]
    got3, _ = pipeline.forward(pipeline.model_tensors(tm3, torch.float64, "cpu"), *t)
    _close_scaled(got3, want, "qacc at 3 iterations")
    # the tolerance splits the envs: some stopped after 1 step, some did not
    got1, _ = pipeline.forward(pipeline.model_tensors(tm, torch.float64, "cpu"), *t)
    stopped = torch.all(got3 == got1, dim=1)
    assert 0 < int(stopped.sum()) < B, stopped
    # a huge tolerance exits before the first step: qacc = qacc_smooth
    tm_huge = pipeline.model_tensors(tm.replace(tolerance=1e9), torch.float64, "cpu")
    st = _stages_torch(tm_huge, qpos, qvel, ctrl)
    assert torch.equal(st["res"].qacc, st["qacc_smooth"])
