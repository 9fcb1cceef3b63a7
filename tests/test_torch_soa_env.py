"""The port's plain wrapped step against puppax's ``wrapped_step_rows_xla``.

``wrapped_step_rows`` evaluates the wrapped-step emission (the program of
the K3 kernel) with torch ops; ``puppax.env.soa_env.wrapped_step_rows_xla``
evaluates the same emission with XLA ops. Same ``(rows, B)`` input blocks,
tolerances of ``tests/test_soa_env.py:131-191``. Env 1 enters with
``prev_done = 1`` and envs 2-3 at ``steps = L - 1``, so the AutoReset
restore and the truncation branch both run.
"""

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env import soa_env as jax_soa_env
from puppax_torch.env import soa_env

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jenv, tenv = H.jax_env(), H.torch_env()
    js, jes = jenv._cv_core._s, jenv._cv_core._es
    jmodel = H.jax_dr_model(jenv)
    blocks = H.wrapped_step_blocks(
        tenv._s, tenv._es, tenv.model, H.jax_dr_rows(js, jmodel), np.random.RandomState(0)
    )
    want = jax_soa_env.wrapped_step_rows_xla(
        js, jes, 1, H.EPISODE_LENGTH, *[np.asarray(b) for b in blocks]
    )
    return tenv, blocks, [np.asarray(w) for w in want]


def test_wrapped_step_rows_matches_xla(setup):
    tenv, blocks, want = setup
    got = soa_env.wrapped_step_rows(tenv._s, tenv._es, 1, H.EPISODE_LENGTH, *H.to_torch(blocks))
    H.assert_wrapped_outputs_close(
        [g.numpy() for g in got], want, tenv._s, tenv._es,
        soa_env.aux_row_map(tenv._es), "torch rows vs xla rows",
    )


def test_branches_are_exercised(setup):
    """The reference outputs show the restore, truncation and a contact."""
    tenv, blocks, want = setup
    es, aux_rows = tenv._es, soa_env.aux_row_map(tenv._es)
    q_out, _, env_out, wrap_out, aux = want
    done = aux[aux_rows["done"][0]]
    trunc = aux[aux_rows["truncation"][0]]
    assert wrap_out[0, 1] == 1.0  # prev_done: episode steps restart at 0 -> 1
    assert (trunc[2:4] == 1.0).any() and (done[2:4] == 1.0).all()
    first_q = blocks[6][: tenv._s.nq]
    np.testing.assert_array_equal(q_out[:, done > 0.5], first_q[:, done > 0.5])
    r0, n = es.env_rows["last_contact"]
    assert env_out[r0 : r0 + n].any()


def test_wrapped_step_wrapper_on_cpu_runs_plain(setup):
    """``wrapped_step`` on CPU tensors is the plain version, counts no
    launch, and refuses malformed blocks."""
    tenv, blocks, _ = setup
    s, es = tenv._s, tenv._es
    before = soa_env.wrapped_step.launches
    got = soa_env.wrapped_step(s, es, 1, H.EPISODE_LENGTH, *H.to_torch(blocks))
    plain = soa_env.wrapped_step_rows(s, es, 1, H.EPISODE_LENGTH, *H.to_torch(blocks))
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert soa_env.wrapped_step.launches == before
    bad = H.to_torch(blocks)
    bad[2] = bad[2].double()
    with pytest.raises(TypeError):
        soa_env.wrapped_step(s, es, 1, H.EPISODE_LENGTH, *bad)
    bad = H.to_torch(blocks)
    bad[4] = bad[4][:-1]
    with pytest.raises(ValueError):
        soa_env.wrapped_step(s, es, 1, H.EPISODE_LENGTH, *bad)
    bad = H.to_torch(blocks)
    bad[0] = bad[0].t().contiguous().t()
    with pytest.raises(ValueError):
        soa_env.wrapped_step(s, es, 1, H.EPISODE_LENGTH, *bad)
