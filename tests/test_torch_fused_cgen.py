"""The fused unroll kernel (K4), compiled for the CPU with g++.

``csrc/fused_unroll.cuh`` around ``cgen.fused_unroll_body`` (K3's generated
body and the unroll's constants) builds with ``g++ -x c++ -O1`` as it
builds with nvcc: outside nvcc its host entry loops over the envs. The
library is built once for the module and run through ctypes on CPU tensors
at T=3, the gait clock off and on, for every hidden activation (runtime
codes, one build), against the plain version ``fused_unroll.unroll_rows``
at the parity tolerances of K3 (``torch_port_helpers``): the final carry
and every step's aux rows as K3's outputs, the observations, actions and
raw actions at 1e-5 and the log-prob at 2e-4. Only the nvcc build and the
launch wait for the card.
"""

import shutil

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.kernels import build, cgen

torch.set_num_threads(1)

T = 3
L = 4  # episode length: every env reaches its limit inside the unroll


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated C cannot be built on the host")
    env = H.torch_env()
    body = cgen.fused_unroll_body(env._s, env._es, 1, L)
    return build.host_library(build.FUSED_UNROLL, body, tmp_path_factory.mktemp("cgenK4"))


@pytest.mark.parametrize("activation", fused_unroll.ACTIVATIONS)
@pytest.mark.parametrize("gait", [False, True], ids=["gait-off", "gait-on"])
def test_generated_c_matches_plain(lib, gait, activation):
    env = PupperV3Env(device="cpu", gait_phase_observation=gait, **H.env_kwargs(1))
    layers, blocks = H.fused_unroll_inputs(env, H.B, T, activation, L)
    s, es = env._s, env._es
    want = fused_unroll.unroll_rows(s, es, 1, L, activation, layers, *blocks)
    obs_dim = es.hist + 2 * gait
    naux = soa_env.block_rows(s, es)[1][4]
    final = [torch.empty(n, H.B) for n in (s.nq, s.nv, es.nenv_rows, 2)]
    scratch = [torch.empty_like(x) for x in final]
    phase = torch.empty(1, H.B) if gait else None
    steps = [torch.empty(T, n, H.B) for n in (obs_dim, 12, 12, 1, naux)]
    weights = torch.cat([torch.cat([w.reshape(-1), b]) for w, b in layers])
    dims = [obs_dim] + [w.shape[0] for w, _ in layers]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = lib.fused_unroll_host(
        *[ptr(x) for x in blocks + [weights] + final + [phase] + steps + scratch],
        H.B, T, len(layers), fused_unroll.ACTIVATIONS.index(activation), int(gait),
        *(dims + [0] * (fused_unroll.MAX_LAYERS + 1 - len(dims))))
    assert rc == 0
    what = f"g++ K4 vs plain, {activation}, gait {gait}"
    aux_rows = soa_env.aux_row_map(es)
    for t in range(T):  # the final carry, with each step's aux rows
        H.assert_wrapped_outputs_close(
            [x.numpy() for x in final + [steps[4][t]]],
            [x.numpy() for x in want[:4] + (want[9][t],)], s, es, aux_rows, f"{what}, step {t}")
    for i, name in ((0, "obs"), (1, "act"), (2, "raw")):
        np.testing.assert_allclose(steps[i].numpy(), want[5 + i].numpy(), atol=1e-5,
                                   err_msg=f"{what}: {name}")
    np.testing.assert_allclose(steps[3].numpy(), want[8].numpy(), atol=2e-4,
                               err_msg=f"{what}: logp")
    done = want[9][:, aux_rows["done"][0]]
    assert (done == 1).any() and (done == 0).any()
    if gait:
        np.testing.assert_allclose(phase.numpy(), want[4].numpy(), rtol=0, atol=1e-6)
