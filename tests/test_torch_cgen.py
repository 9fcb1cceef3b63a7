"""The generated CUDA C of the wrapped step, compiled for the CPU with g++.

``kernels/cgen.py`` emits the K3 kernel's per-env body as C; the launch
shell ``csrc/wrapped_step.cuh`` defines ``__host__ __device__`` away
outside nvcc and adds a host loop over the envs. These tests compile the
same source the card builds with ``g++ -x c++ -O1``, call it through
ctypes on CPU tensors and hold it against ``wrapped_step_rows`` at the
wrapped-step tolerances: this checks the C back-end's semantics here;
only the nvcc build and the launch wait for the card.
"""

import re
import shutil

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch.env import soa_env
from puppax_torch.kernels import build, cgen
from puppax_torch.physics import soa

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[1, 2], ids=["1substep", "2substeps"])
def compiled(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated C cannot be built on the host")
    n = request.param
    env = H.torch_env(n_substeps=n)
    body = cgen.wrapped_step_body(env._s, env._es, n, H.EPISODE_LENGTH)
    lib = build.host_library(body, tmp_path_factory.mktemp(f"cgen{n}"))
    return env, n, body, lib


def _run_host(lib, s, es, blocks):
    B = blocks[0].shape[1]
    _, out_rows = soa_env.block_rows(s, es)
    outs = [torch.empty((k, B), dtype=torch.float32) for k in out_rows]
    rc = lib.wrapped_step_host(*[t.data_ptr() for t in list(blocks) + outs], B)
    assert rc == 0
    return outs


def test_generated_c_matches_plain(compiled):
    env, n, _, lib = compiled
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, H.B)).numpy()
    blocks = H.to_torch(
        H.wrapped_step_blocks(s, es, env.model, dr, np.random.RandomState(20 + n))
    )
    got = _run_host(lib, s, es, blocks)
    want = soa_env.wrapped_step_rows(s, es, n, H.EPISODE_LENGTH, *blocks)
    H.assert_wrapped_outputs_close(
        [g.numpy() for g in got], [w.numpy() for w in want], s, es,
        soa_env.aux_row_map(es), f"g++ C vs torch rows, {n} substeps",
    )


def test_generated_c_structure(compiled):
    """Every float literal carries the f suffix (no silent double), the
    substep loop is a real C loop iff n > 1, and the line search keeps its
    12 expand / 24 Illinois trips."""
    env, n, body, _ = compiled
    code = re.sub(r"//[^\n]*", "", body)
    bare = re.findall(r"(?<![\w.])\d+\.\d*(?:e[+-]?\d+)?(?![\w.])", code)
    assert not bare, bare[:5]
    loops = re.findall(r"for \(int (\w+) = 0; \1 < (\d+);", code)
    trips = sorted(int(t) for _, t in loops)
    assert trips.count(soa.LS_EXPAND_ITERS) == n
    assert trips.count(soa.LS_ILLINOIS_ITERS) == n
    assert trips.count(n - 1) == (1 if n > 1 else 0)
