"""puppax_torch.ops.math against puppax.ops.math in float64.

The JAX helpers take single operands (batched by ``vmap``); the port's take
a leading batch axis. Both get the same random numpy operands and must
agree to 1e-12 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puppax.ops import math as jm
from puppax_torch.ops import math as tm

torch.set_num_threads(1)

N = 16


def _unit_quats(rng):
    q = rng.normal(size=(N, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rot_mats(rng):
    return np.stack([np.asarray(jm.quat_to_mat(jnp.asarray(q))) for q in _unit_quats(rng)])


# name -> (operand makers, jax fn on single operands, torch fn on batches)
CASES = {
    "quat_mul": ((_unit_quats, _unit_quats), jm.quat_mul, tm.quat_mul),
    "quat_inv": ((_unit_quats,), jm.quat_inv, tm.quat_inv),
    "rotate": ((lambda r: r.normal(size=(N, 3)), _unit_quats), jm.rotate, tm.rotate),
    "rotate_inv": ((lambda r: r.normal(size=(N, 3)), _unit_quats), jm.rotate_inv,
                   tm.rotate_inv),
    "quat_to_mat": ((_unit_quats,), jm.quat_to_mat, tm.quat_to_mat),
    "euler_to_quat": ((lambda r: r.uniform(-180, 180, (N, 3)),), jm.euler_to_quat,
                      tm.euler_to_quat),
    "normalize": ((lambda r: r.normal(size=(N, 3)),), jm.normalize, tm.normalize),
    "quat_integrate": ((_unit_quats, lambda r: r.normal(size=(N, 3)),
                        lambda r: np.full(N, 0.004)),
                       jm.quat_integrate, lambda q, w, dt: tm.quat_integrate(q, w, dt[:, None])),
    "motion_cross": ((lambda r: r.normal(size=(N, 6)),) * 2, jm.motion_cross,
                     tm.motion_cross),
    "motion_cross_force": ((lambda r: r.normal(size=(N, 6)),) * 2,
                           jm.motion_cross_force, tm.motion_cross_force),
    "inert_mul": ((lambda r: r.normal(size=(N, 6, 6)), lambda r: r.normal(size=(N, 6))),
                  jm.inert_mul, tm.inert_mul),
    "transform_inertia": ((lambda r: r.uniform(0.1, 2.0, N),
                           lambda r: r.uniform(1e-4, 1e-2, (N, 3)),
                           lambda r: r.normal(size=(N, 3)) * 0.05, _rot_mats),
                          jm.transform_inertia, tm.transform_inertia),
    "transform_motion": ((lambda r: r.normal(size=(N, 6)), lambda r: r.normal(size=(N, 3))),
                         jm.transform_motion, tm.transform_motion),
    "ad_dual": ((lambda r: r.normal(size=(N, 3)), lambda r: r.normal(size=(N, 6))),
                jm.ad_dual, tm.ad_dual),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_jax_f64(x64, name):
    makers, jfn, tfn = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    args = [mk(rng) for mk in makers]
    want = jax.vmap(jfn)(*[jnp.asarray(a, jnp.float64) for a in args])
    got = tfn(*[torch.as_tensor(a, dtype=torch.float64) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12,
                                   err_msg=name)


def test_apply_lagged_value_matches_jax():
    """Push-front + one-hot lag select, batched, equals the JAX helper."""
    from puppax import utils as ju
    from puppax_torch import utils as tu

    rng = np.random.RandomState(7)
    buf = rng.normal(size=(N, 6, 3)).astype(np.float32)
    new = rng.normal(size=(N, 6)).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.randint(3, size=N)]
    want_s, want_b = jax.vmap(ju.apply_lagged_value)(buf, new, onehot)
    got_s, got_b = tu.apply_lagged_value(torch.from_numpy(buf), torch.from_numpy(new),
                                         torch.from_numpy(onehot))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("name", ["relu", "sigmoid", "elu", "tanh", "softmax"])
def test_activation_map_matches_jax(name):
    from puppax import utils as ju
    from puppax_torch import utils as tu

    x = np.random.RandomState(8).normal(size=(N, 5)).astype(np.float32)
    np.testing.assert_allclose(tu.activation_fn_map(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(ju.activation_fn_map(name)(jnp.asarray(x))),
                               atol=1e-6)
    with pytest.raises(KeyError):
        tu.activation_fn_map("swishy")


def test_latency_onehot_picks_by_inverse_cdf():
    """One-hot rows, one per key; the first column is chosen with its
    probability."""
    from puppax_torch import random
    from puppax_torch import utils as tu

    oh = tu.latency_onehot(random.split(random.key(0), 20000), np.array([0.2, 0.8], np.float32))
    assert oh.shape == (20000, 2) and (oh.sum(1) == 1).all()
    assert abs(float(oh[:, 0].mean()) - 0.2) < 0.02
