"""The K3 kernel on an NVIDIA GPU against its plain version.

These tests need a CUDA device and nvcc; without them they skip. On the
GPU host (which has no JAX) run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch.env import soa_env
from puppax_torch.physics import soa

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU host with "
                    "`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda`")
    return H.torch_env(n_substeps=5, device="cuda")


def _blocks(env, B, seed):
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = H.wrapped_step_blocks(s, es, env.model, dr, np.random.RandomState(seed), n=B,
                                   episode_length=1000)
    return [b.cuda() for b in H.to_torch(blocks)]


@pytest.mark.parametrize("B", [256, 300])
def test_kernel_matches_plain(env, B):
    """Full and ragged last blocks (the b < B guard) on random states."""
    s, es = env._s, env._es
    blocks = _blocks(env, B, seed=B)
    before = soa_env.wrapped_step.launches
    got = soa_env.wrapped_step(s, es, 5, 1000, *blocks)
    torch.cuda.synchronize()
    assert soa_env.wrapped_step.launches == before + 1
    want = soa_env.wrapped_step_rows(s, es, 5, 1000, *blocks)
    H.assert_wrapped_outputs_close(
        [g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want], s, es,
        soa_env.aux_row_map(es), f"kernel vs plain at B={B}",
    )


def test_wrapper_refuses_bad_blocks(env):
    s, es = env._s, env._es
    blocks = _blocks(env, 128, seed=1)
    mixed = list(blocks)
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError):
        soa_env.wrapped_step(s, es, 5, 1000, *mixed)
    strided = list(blocks)
    strided[0] = blocks[0].t().contiguous().t()
    with pytest.raises(ValueError):
        soa_env.wrapped_step(s, es, 5, 1000, *strided)
