"""The physics-only step: K1's plain version against puppax's XLA pipeline,
and ``pipeline.make_batched_step``'s routing.

* ``soa.physics_step_rows`` (the K1 emission evaluated with torch ops)
  against ``puppax``'s ``pipeline_step`` (vmapped, jitted) at 1 and 2
  substeps, on in-cap states: feet on the floor and nothing else touching,
  so the MJX caps of the XLA path keep every penetrating pair and the
  uncapped emission must agree with it. qpos 5e-5, qvel 5e-4 scaled, the
  caches at ``torch_port_helpers.CACHE_ATOL`` / ``CACHE_SCALED``. The
  nominal model is held at the emission's own line-search trips, as
  ``tests/test_soa.py:508`` holds puppax's emission.
* A domain-randomized model: there the emission's Illinois line search
  (12 expand + 24 Illinois trips, ``soa.LS_*_ITERS``) stops short of the
  exact line search of the XLA solver on some envs (puppax's own emission
  parts from its XLA path the same way, by up to 1.5e-4 in qpos on these
  states). With the trips raised, the plain version meets the same
  tolerances, so the gap is the line search's convergence, not the
  physics.
* The routing: float32 CPU tensors run the plain version, float64 and
  ``PUPPAX_SOA=off`` the torch ``pipeline_step``; the wrapper checks its
  blocks and refuses a device it has no kernel for.

The g++ build of K1's generated C is held against the plain version in
``tests/test_torch_cgen.py``; the kernel itself in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env.domain_randomization import domain_randomize
from puppax.physics import pipeline as jpipe
from puppax_torch.model.mjcf import load_model
from puppax_torch.physics import pipeline, soa

torch.set_num_threads(1)

SUBSTEPS = (1, 2)


def _cache_block(s, ps) -> np.ndarray:
    """A JAX PhysicsState (numpy leaves) as the ``(ncache, B)`` block."""
    parts = {
        "qacc": ps.qacc, "xpos": ps.xpos, "xquat": ps.x_rot, "xd_ang": ps.xd_ang,
        "xd_vel": ps.xd_vel, "site_xpos": ps.site_xpos, "qfrc_actuator": ps.qfrc_actuator,
        "con_dist": ps.contact.dist, "con_pos": ps.contact.pos,
    }
    n = ps.qpos.shape[0]
    return np.concatenate([np.asarray(parts[name]).reshape(n, k)
                           for name, (_, k) in s.cache_rows.items()], 1).T


@pytest.fixture(scope="module")
def setup():
    """The port's env, a DR-batched model carried from puppax, in-cap
    states, and puppax's XLA pipeline_step on them at 1 and 2 substeps,
    for the nominal model and the DR batch (one jit)."""
    jenv, tenv = H.jax_env(), H.torch_env()
    s = tenv._s
    jmodel, in_axes = domain_randomize(jenv.model, jax.random.split(jax.random.PRNGKey(5), H.B))
    tmodel = tenv.model.with_leaves(**H.dr_leaves(jmodel))
    dr = soa.dr_rows_block(s, soa.dr_inputs(tmodel, s, H.B)).numpy()
    blocks = H.physics_step_blocks(tenv.model, dr, np.random.RandomState(0))
    q, v, c = (b.T for b in blocks[:3])

    # one jit of one puppax substep, run twice for 2 substeps (the same
    # forward + Euler passes as pipeline_step(n=2)); the nominal model as a
    # DR batch of identical rows, so both models share the compilation
    step1 = jax.jit(jax.vmap(lambda mm, qp, qv, ct: jpipe.pipeline_step(
        mm, jpipe._zeros_state(mm, qp, qv), ct, 1), in_axes=(in_axes, 0, 0, 0)))
    nominal = jmodel.replace(**{k: jnp.broadcast_to(getattr(jenv.model, k),
                                                    getattr(jmodel, k).shape)
                                for k in H.dr_leaves(jmodel)})
    want = {}
    for name, mm in (("nominal", nominal), ("dr", jmodel)):
        one = step1(mm, q, v, c)
        two = step1(mm, one.qpos, one.qvel, c)
        want[name] = {1: jax.tree_util.tree_map(np.asarray, one),
                      2: jax.tree_util.tree_map(np.asarray, two)}
    nominal_dr = tenv.dr_rows(H.B)
    tblocks = H.to_torch(blocks)
    return tenv, tmodel, {"nominal": tblocks[:3] + [nominal_dr], "dr": tblocks}, want


def test_states_are_in_cap_and_touch(setup):
    tenv, _, _, want = setup
    for model in want:
        for n, ps in want[model].items():
            counts = H.penetrating_pairs(tenv._s, ps.contact.dist.T)
            assert H.within_caps(tenv.model, counts).all(), (model, n, counts)
            assert counts[:, 0].sum() > 0, "no foot touches the floor"


def _check_against_xla(s, got, ps, what):
    H.assert_physics_outputs_close([g.numpy() for g in got],
                                   [ps.qpos.T, ps.qvel.T, _cache_block(s, ps)], s, what)


@pytest.mark.parametrize("n_substeps", SUBSTEPS)
def test_physics_step_rows_matches_xla_pipeline(setup, n_substeps):
    tenv, _, blocks, want = setup
    s = tenv._s
    got = soa.physics_step_rows(s, n_substeps, *blocks["nominal"])
    _check_against_xla(s, got, want["nominal"][n_substeps],
                       f"K1 plain vs XLA pipeline_step, {n_substeps} substeps")


@pytest.mark.parametrize("n_substeps", SUBSTEPS)
def test_dr_gap_is_the_line_search(setup, n_substeps, monkeypatch):
    """On the DR batch the emission parts from the XLA path on some envs at
    its own trips, and meets the tolerances once its line search runs to
    convergence."""
    tenv, _, blocks, want = setup
    s = tenv._s
    ps = want["dr"][n_substeps]
    short = soa.physics_step_rows(s, n_substeps, *blocks["dr"])
    assert np.abs(short[0].numpy() - ps.qpos.T).max() > 5e-5
    monkeypatch.setattr(soa, "LS_EXPAND_ITERS", 40)
    monkeypatch.setattr(soa, "LS_ILLINOIS_ITERS", 200)
    got = soa.physics_step_rows(s, n_substeps, *blocks["dr"])
    _check_against_xla(s, got, ps, f"K1 plain (line search converged) vs XLA, DR, "
                                   f"{n_substeps} substeps")


@pytest.mark.parametrize("n_substeps", SUBSTEPS)
def test_batched_step_on_cpu_is_the_plain_version(setup, n_substeps):
    """float32 CPU tensors: ``make_batched_step`` runs ``physics_step_rows``
    with the DR rows made from the model, and counts no launch."""
    tenv, tmodel, blocks, _ = setup
    s = tenv._s
    step = pipeline.make_batched_step(tenv.model, n_substeps, load_model().mj)
    blocks = blocks["dr"]
    q, v, c, dr = blocks
    before = soa.step_batched.launches
    got = step(tmodel, q.t(), v.t(), c.t())
    assert soa.step_batched.launches == before
    plain = soa.physics_step_rows(s, n_substeps, *blocks)
    ps = pipeline.physics_state_from_caches(s, plain[0].t(), plain[1].t(), plain[2])
    for name, g in zip(pipeline.PhysicsState.__dataclass_fields__, got):
        assert torch.equal(g, getattr(ps, name)), name
    # the DR rows the caller keeps give the same step
    again = step(tmodel, q.t(), v.t(), c.t(), dr_rows=dr)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_batched_step_routes_float64_and_soa_off_to_the_pipeline(setup, monkeypatch):
    tenv, tmodel, blocks, _ = setup
    step = pipeline.make_batched_step(tenv.model, 1, load_model().mj)
    blocks = blocks["dr"]
    q, v, c = (b.t().double() for b in blocks[:3])
    want = pipeline.pipeline_step(tmodel, pipeline._zeros_state(tmodel, q, v), c, 1)
    got = step(tmodel, q, v, c)
    assert got[0].dtype == torch.float64
    for name, g in zip(pipeline.PhysicsState.__dataclass_fields__, got):
        assert torch.equal(g, getattr(want, name)), name

    monkeypatch.setenv("PUPPAX_SOA", "off")
    q, v, c = (b.t() for b in blocks[:3])
    want = pipeline.pipeline_step(tmodel, pipeline._zeros_state(tmodel, q, v), c, 1)
    before = soa.step_batched.launches
    got = step(tmodel, q, v, c)
    assert soa.step_batched.launches == before
    for name, g in zip(pipeline.PhysicsState.__dataclass_fields__, got):
        assert torch.equal(g, getattr(want, name)), name


def test_step_batched_checks_blocks_and_devices(setup):
    tenv, _, blocks, _ = setup
    s = tenv._s
    blocks = blocks["dr"]
    bad = list(blocks)
    bad[3] = bad[3].double()
    with pytest.raises(TypeError):
        soa.step_batched(s, *bad, 1)
    bad = list(blocks)
    bad[2] = bad[2][:-1]
    with pytest.raises(ValueError):
        soa.step_batched(s, *bad, 1)
    with pytest.raises(ValueError):
        soa.step_batched(s, *[b.to("meta") for b in blocks], 1)
    assert [x.shape[0] for x in soa.step_batched(s, *blocks, 1)] == [s.nq, s.nv, s.ncache]
