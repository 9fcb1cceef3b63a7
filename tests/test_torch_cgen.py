"""The generated CUDA C of the three kernels, compiled for the CPU with g++.

``kernels/cgen.py`` emits each kernel's per-env body as C: the wrapped step
(K3, shell ``csrc/wrapped_step.cuh``), the unwrapped step with its
physics caches (K2, shell ``csrc/env_step.cuh``) and the physics-only step
(K1, shell ``csrc/physics_step.cuh``). The shells define
``__host__ __device__`` away outside nvcc and add a host loop over the
envs. These tests compile the same source the card builds with
``g++ -x c++ -O1``, call it through ctypes on CPU tensors and hold it
against the plain version (``wrapped_step_rows`` / ``env_step_rows`` /
``soa.physics_step_rows``) at
the parity tolerances: this checks the C back-end's semantics here; only
the nvcc build and the launch wait for the card.
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

CASES = [("K3", 1), ("K3", 2), ("K2", 1), ("K2", 2), ("K1", 2)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{k}-{n}substep" for k, n in CASES])
def compiled(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated C cannot be built on the host")
    name, n = request.param
    env = H.torch_env(n_substeps=n)
    s, es = env._s, env._es
    if name == "K3":
        kernel, body = build.WRAPPED_STEP, cgen.wrapped_step_body(s, es, n, H.EPISODE_LENGTH)
    elif name == "K2":
        kernel, body = build.ENV_STEP, cgen.env_step_body(s, es, n)
    else:
        kernel, body = build.PHYSICS_STEP, cgen.physics_step_body(s, n)
    lib = build.host_library(kernel, body, tmp_path_factory.mktemp(f"cgen{name}{n}"))
    return name, env, n, body, lib


def _run_host(fn, blocks, out_rows):
    B = blocks[0].shape[1]
    outs = [torch.empty((k, B), dtype=torch.float32) for k in out_rows]
    assert fn(*[t.data_ptr() for t in list(blocks) + outs], B) == 0
    return outs


def test_generated_c_matches_plain(compiled):
    name, env, n, _, lib = compiled
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, H.B)).numpy()
    rng = np.random.RandomState(20 + n)
    what = f"g++ C vs torch rows, {name}, {n} substeps"
    if name == "K3":
        blocks = H.to_torch(H.wrapped_step_blocks(s, es, env.model, dr, rng))
        got = _run_host(lib.wrapped_step_host, blocks, soa_env.block_rows(s, es)[1])
        want = soa_env.wrapped_step_rows(s, es, n, H.EPISODE_LENGTH, *blocks)
        H.assert_wrapped_outputs_close([g.numpy() for g in got], [w.numpy() for w in want],
                                       s, es, soa_env.aux_row_map(es), what)
    elif name == "K2":
        blocks = H.to_torch(H.env_step_blocks(s, es, env.model, dr, rng))
        got = _run_host(lib.env_step_host, blocks, soa_env.env_block_rows(s, es)[1])
        want = soa_env.env_step_rows(s, es, n, *blocks)
        H.assert_env_outputs_close([g.numpy() for g in got], [w.numpy() for w in want],
                                   s, es, what)
    else:
        blocks = H.to_torch(H.physics_step_blocks(env.model, dr, rng))
        got = _run_host(lib.physics_step_host, blocks, soa.physics_block_rows(s)[1])
        want = soa.physics_step_rows(s, n, *blocks)
        H.assert_physics_outputs_close([g.numpy() for g in got], [w.numpy() for w in want],
                                       s, what)


def test_generated_c_structure(compiled):
    """Every float literal carries the f suffix (no silent double), the
    substep loop is a real C loop iff n > 1, and the line search keeps its
    12 expand / 24 Illinois trips."""
    _, _, n, body, _ = compiled
    code = re.sub(r"//[^\n]*", "", body)
    bare = re.findall(r"(?<![\w.])\d+\.\d*(?:e[+-]?\d+)?(?![\w.])", code)
    assert not bare, bare[:5]
    loops = re.findall(r"for \(int (\w+) = 0; \1 < (\d+);", code)
    trips = sorted(int(t) for _, t in loops)
    assert trips.count(soa.LS_EXPAND_ITERS) == n
    assert trips.count(soa.LS_ILLINOIS_ITERS) == n
    assert trips.count(n - 1) == (1 if n > 1 else 0)


def test_op_count_weights_loops(compiled):
    """``cgen.op_count`` weights each line by the trips of the loops
    around it, and counts only the lines whose value reaches a store."""
    body = compiled[3]
    assert cgen.op_count(body) > 10_000
    snippet = ("  const float t1 = a * b;\n  const float t5 = t1 * t1;\n"
               "  for (int i2 = 0; i2 < 12; ++i2) {\n"
               "    const float t3 = pmax(t1 + (-0.5f), c4);\n    out[0 * B + b] = t3;\n  }\n")
    assert cgen.op_count(snippet) == 1 + 12 * 2
