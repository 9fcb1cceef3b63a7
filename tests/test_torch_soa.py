"""The port's physics emission (torch back-end) against puppax's emission.

Both packages evaluate the same value-algebra program: ``puppax`` on JAX
arrays, the port on ``(B,)`` torch tensors. Same random states, same DR
rows (``puppax.physics.soa.dr_inputs`` of a JAX-randomized model), and
the tolerances of ``tests/test_soa.py:199-204``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.physics import soa as jsoa
from puppax_torch.physics import soa as tsoa

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jenv, tenv = H.jax_env(), H.torch_env()
    js, ts = jenv._cv_core._s, tenv._s
    jmodel = H.jax_dr_model(jenv)
    tmodel = tenv.model.with_leaves(**H.dr_leaves(jmodel))
    return js, ts, jmodel, tmodel


def _jrows(x):
    return [jnp.asarray(r) for r in np.asarray(x, np.float32).T]


def _trows(x):
    return list(torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).T)))


def _np(x, ref):
    return np.asarray(jsoa.materialize(x, ref)) if not isinstance(ref, torch.Tensor) \
        else tsoa.materialize(x, ref).numpy()


def test_dr_inputs_match(setup):
    """The port's DR rows of the carried-across batched model equal
    puppax's, row for row (one friction scalar per env on every pair)."""
    js, ts, jmodel, tmodel = setup
    want = jsoa.dr_inputs(jmodel, js, H.B)
    got = tsoa.dr_inputs(tmodel, ts, H.B)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    gf = np.asarray(jmodel.geom_friction)[:, :, 0]
    np.testing.assert_array_equal(got["pair_mu"].numpy(), np.repeat(gf[:, :1], ts.npair, 1))


def test_fk_matches(setup):
    js, ts, *_ = setup
    qpos, _, _ = H.random_states(setup[2], np.random.RandomState(1))
    jq, tq = _jrows(qpos), _trows(qpos)
    want = jsoa._emit_fk(js, jq, None)
    got = tsoa._emit_fk(ts, tq, None)
    for name, w_list, g_list in zip(("xpos", "xquat", "xanchor", "xaxis"), want, got):
        for i, (w, g) in enumerate(zip(w_list, g_list)):
            np.testing.assert_allclose(
                np.stack([_np(c, tq[0]) for c in g]),
                np.stack([_np(c, jq[0]) * np.ones(H.B) for c in w]),
                atol=1e-6, err_msg=f"{name}[{i}]",
            )


@pytest.mark.parametrize("n_substeps", [1, 2])
def test_substeps_match(setup, n_substeps):
    """q, v after n substeps (+ the final integrate) and the last forward
    pass's contact distances; n=2 runs the substep loop in both."""
    js, ts, jmodel, tmodel = setup
    rng = np.random.RandomState(10 + n_substeps)
    qpos, qvel, ctrl = H.random_states(jmodel, rng)
    jdr = {k: _jrows(v) for k, v in jsoa.dr_inputs(jmodel, js, H.B).items()}
    tdr = {k: list(v.t().contiguous()) for k, v in tsoa.dr_inputs(tmodel, ts, H.B).items()}

    jq, jv, jc = _jrows(qpos), _jrows(qvel), _jrows(ctrl)
    with jax.disable_jit():  # the substep fori_loop as a Python loop
        qp, vp, fw = jsoa._emit_substeps(js, jq, jv, jc, jdr, n_substeps)
        jq2, jv2 = jsoa._emit_integrate(js, qp, vp, fw["qacc"])
        jdist = fw["con_dist"]

    tq, tv, tc = _trows(qpos), _trows(qvel), _trows(ctrl)
    qp, vp, fw = tsoa._emit_substeps(ts, tq, tv, tc, tdr, n_substeps)
    tq2, tv2 = tsoa._emit_integrate(ts, qp, vp, fw["qacc"])

    def mat(xs, ref):
        return np.stack([_np(x, ref) for x in xs], 1)

    want_q, got_q = mat(jq2, jq[0]), mat(tq2, tq[0])
    want_v, got_v = mat(jv2, jq[0]), mat(tv2, tq[0])
    np.testing.assert_allclose(got_q, want_q, atol=5e-5, err_msg="qpos")
    scale = np.maximum(1.0, np.abs(want_v).max(axis=1, keepdims=True))
    np.testing.assert_allclose(got_v / scale, want_v / scale, atol=5e-4, err_msg="qvel")
    np.testing.assert_allclose(mat(fw["con_dist"], tq[0]), mat(jdist, jq[0]),
                               atol=5e-5, err_msg="con_dist")
    # the states exercise contacts: some pairs penetrate
    assert (mat(jdist, jq[0]) < 0).any()
