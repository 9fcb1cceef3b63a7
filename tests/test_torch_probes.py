"""The kernel-time probes (``puppax_torch/probes``) on the CPU.

- The port's phase cuts of the physics emission (``soa.PHASES``) against
  ``puppax``'s ``PHASE_LIMIT`` emission on the same states, at the
  tolerances of ``tests/test_soa.py:199-204``.
- The probes' CUDA sources built with g++ (``csrc/probe_physics.cuh`` in
  both layouts, the multiply-add chain, ``x + 1`` in both designs) against
  their plain versions; the card's builds wait for
  ``tests/test_torch_cuda.py``.
- The sink row that keeps a cut pass live, the live operation count, the
  layout helpers, the cut bodies, the build records, the wrappers' checks
  and the probes' command lines without a card.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.physics import soa as jsoa
from puppax_torch.kernels import build, cgen
from puppax_torch.physics import soa as tsoa
from puppax_torch.probes import common, probe_fma_fusion, probe_launch_overhead
from puppax_torch.probes import profile_kernel_phases, profile_layout

torch.set_num_threads(1)

CUTS = [c for c in tsoa.PHASES if c is not None]
PROBES = (profile_kernel_phases, profile_layout, probe_fma_fusion, probe_launch_overhead)


@pytest.fixture(scope="module")
def setup():
    jenv, tenv = H.jax_env(), H.torch_env()
    js, ts = jenv._cv_core._s, tenv._s
    jmodel = H.jax_dr_model(jenv)
    tmodel = tenv.model.with_leaves(**H.dr_leaves(jmodel))
    return js, ts, jmodel, tmodel


def _jrows(x):
    return [jax.numpy.asarray(r) for r in np.asarray(x, np.float32).T]


@pytest.mark.parametrize("cut", CUTS)
def test_phase_cut_matches_jax(setup, cut, monkeypatch):
    """One substep of the emission cut after ``cut``: the port's
    ``emit_physics_rows(..., phase_limit=cut)`` against puppax's
    ``_emit_substeps`` + ``_emit_integrate`` under its ``PHASE_LIMIT``:
    q', v', qacc and, where the cut has them, the contact distances."""
    js, ts, jmodel, tmodel = setup
    qpos, qvel, ctrl = H.random_states(jmodel, np.random.RandomState(40))
    jdr = {k: _jrows(v) for k, v in jsoa.dr_inputs(jmodel, js, H.B).items()}
    monkeypatch.setattr(jsoa, "PHASE_LIMIT", cut)
    with jax.disable_jit():
        qp, vp, fw = jsoa._emit_substeps(js, _jrows(qpos), _jrows(qvel), _jrows(ctrl), jdr, 1)
        jq2, jv2 = jsoa._emit_integrate(js, qp, vp, fw["qacc"])
    ref = jax.numpy.zeros(H.B, jax.numpy.float32)
    want = {name: np.stack([np.asarray(jsoa.materialize(x, ref)) for x in xs])
            for name, xs in (("q", jq2), ("v", jv2), ("qacc", fw["qacc"]),
                             ("con_dist", fw["con_dist"]))}

    dr = tsoa.dr_rows_block(ts, tsoa.dr_inputs(tmodel, ts, H.B))
    rows = [list(x) for x in (*H.to_torch([qpos.T, qvel.T, ctrl.T]), dr)]
    got_q, got_v, caches = (torch.stack([tsoa.materialize(x, rows[0][0]) for x in xs])
                            for xs in tsoa.emit_physics_rows(ts, 1, rows, cut))
    with_sink = tsoa.physics_step_rows(ts, 1, *[torch.stack(r) for r in rows], phase_limit=cut,
                                       sink=True)
    for g, w in zip(with_sink, (got_q, got_v, caches)):  # the sink row changes nothing else
        assert torch.equal(g, w)
    assert with_sink[3].shape == (1, H.B) and torch.isfinite(with_sink[3]).all()

    np.testing.assert_allclose(got_q.numpy(), want["q"], atol=5e-5, rtol=0, err_msg="qpos")
    scale = np.maximum(1.0, np.abs(want["v"]).max(axis=0, keepdims=True))
    np.testing.assert_allclose(got_v.numpy() / scale, want["v"] / scale, atol=5e-4, rtol=0,
                               err_msg="scaled qvel")
    r0, n = ts.cache_rows["qacc"]
    qacc = caches[r0 : r0 + n].numpy()
    scale = np.maximum(1.0, np.abs(want["qacc"]).max(axis=0, keepdims=True))
    np.testing.assert_allclose(qacc / scale, want["qacc"] / scale, atol=5e-5, rtol=0,
                               err_msg="qacc")
    if cut in ("fk", "compos", "comvel", "crb", "rne"):  # padded with q[0], as puppax pads
        np.testing.assert_array_equal(qacc, np.broadcast_to(qpos[:, 0], qacc.shape))
    if cut == "efc":
        r0, n = ts.cache_rows["con_dist"]
        np.testing.assert_allclose(caches[r0 : r0 + n].numpy(), want["con_dist"], atol=5e-5,
                                   rtol=0, err_msg="con_dist")
        assert (want["con_dist"] < 0).any()  # some pairs penetrate


def test_uncut_body_is_the_production_body():
    """``phase_limit=None`` emits exactly today's K1 body; every cut's
    body is shorter, and its header names the cut."""
    s = H.torch_env()._s
    full = cgen.physics_step_body(s, 1)
    assert cgen.physics_step_body(s, 1, phase_limit=None) == full
    sizes = []
    for cut in CUTS:
        body = cgen.physics_step_body(s, 1, cut)
        assert f"cut after phase {cut}" in body.splitlines()[1]
        sizes.append(body.count("\n"))
    assert sizes == sorted(sizes) and sizes[-1] < full.count("\n")
    with pytest.raises(ValueError):
        cgen.physics_step_body(s, 1, "newton")


def test_sink_keeps_each_phase_live():
    """Without the sink row, the cuts before ``smooth`` leave only FK live
    (``cgen.op_count`` counts the lines that reach a store, as nvcc keeps
    them): their live counts are equal. With it, each cut does more live
    work than the one before, and the whole body stores a constant 0."""
    s = H.torch_env()._s
    plain = [cgen.op_count(cgen.physics_step_body(s, 2, cut)) for cut in CUTS[:5]]
    assert len(set(plain)) == 1
    sunk = [cgen.op_count(cgen.physics_step_body(s, 2, cut, sink=True)) for cut in CUTS]
    assert sunk == sorted(set(sunk)) and sunk[0] > plain[0]
    full = cgen.physics_step_body(s, 2, None, sink=True)
    assert "sink_out[0 * B + b] = 0.0f;" in full
    assert cgen.op_count(full) == cgen.op_count(cgen.physics_step_body(s, 2))


def test_build_records_keep_variants_apart():
    """A probe build never shares a ``last_build`` record (or a loaded
    library) with a production one: the shell, the cut and the flags are
    in its name; production names are unchanged."""
    assert build.record_name(build.PHYSICS_STEP) == "physics_step"
    assert build.probe_flags(False) == build.NVCC_FLAGS
    fmad = build.probe_flags(True)
    assert "--fmad=true" in fmad and "--fmad=false" not in fmad
    assert "--fmad=false" in build.NVCC_FLAGS
    names = {build.record_name(build.PROBE_PHYSICS, cut or "full", build.probe_flags(f))
             for cut in tsoa.PHASES for f in (False, True)}
    names |= {build.record_name(k, "", build.probe_flags(f))
              for k in (build.PHYSICS_STEP, build.WRAPPED_STEP, build.FMA_CHAIN)
              for f in (False, True)}
    assert len(names) == 2 * len(tsoa.PHASES) + 6
    assert build.record_name(build.WRAPPED_STEP, "", fmad) == "wrapped_step[--fmad=true]"
    assert build.record_name(build.PROBE_PHYSICS, "fk") == "probe_physics[fk]"


def test_block_major_round_trip():
    x = torch.arange(5 * 256, dtype=torch.float32).reshape(5, 256)
    bm = common.to_block_major(x)
    assert bm.shape == (2, 5, 128) and bm.is_contiguous()
    assert torch.equal(bm[1, 3], x[3, 128:])
    assert torch.equal(common.from_block_major(bm), x)
    with pytest.raises(ValueError):
        common.to_block_major(x[:, :200])


def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the probes' C cannot be built on the host")


@pytest.fixture(scope="module", params=["fk", "smooth"])
def probe_host(request, tmp_path_factory):
    _gxx()
    env = H.torch_env()
    body = cgen.physics_step_body(env._s, 1, request.param, sink=True)
    return request.param, env, build.host_library(
        build.PROBE_PHYSICS, body, tmp_path_factory.mktemp(f"probe{request.param}"))


def test_probe_shell_host_build_matches_plain(probe_host):
    """``csrc/probe_physics.cuh``'s host loop over the g++-built cut body,
    row-major and block-major at 128 envs, against the plain version with
    the cut (q, v and caches at the parity tolerances; the sink row, a sum
    of ~1e3 values of up to ~1e3 whose libm rounding differs, at 1e-4
    relative plus 1e-3); block-major equals row-major bit for bit."""
    cut, env, lib = probe_host
    s, B = env._s, 128
    dr = tsoa.dr_rows_block(s, tsoa.dr_inputs(env.model, s, B)).numpy()
    blocks = H.to_torch(H.physics_step_blocks(env.model, dr, np.random.RandomState(41), n=B))
    rows = (s.nq, s.nv, s.nu, s.ndr, s.ncache)

    def host(ins, layout):
        outs = common.empty_outputs(s, B, "cpu", layout)
        rc = lib.probe_physics_host(*[t.data_ptr() for t in list(ins) + outs], B, 128,
                                    layout, *rows)
        assert rc == 0
        return outs

    row = host(blocks, common.ROW_MAJOR)
    block = host([common.to_block_major(x) for x in blocks], common.BLOCK_MAJOR)
    want = tsoa.physics_step_rows(s, 1, *blocks, phase_limit=cut, sink=True)
    H.assert_physics_outputs_close([g.numpy() for g in row[:3]], [w.numpy() for w in want[:3]],
                                   s, f"g++ probe shell vs plain, cut {cut}")
    np.testing.assert_allclose(row[3].numpy(), want[3].numpy(), rtol=1e-4, atol=1e-3,
                               err_msg="sink row")
    for r, b in zip(row, block):
        assert torch.equal(common.from_block_major(b), r)
    ragged = [x[:, :100].contiguous() for x in blocks]
    outs = common.empty_outputs(s, 100, "cpu")
    assert lib.probe_physics_host(*[t.data_ptr() for t in ragged + outs], 100, 128, 0,
                                  *rows) != 0


@pytest.fixture(scope="module")
def chain_host(tmp_path_factory):
    _gxx()
    return build.host_library(build.FMA_CHAIN, "", tmp_path_factory.mktemp("chain"))


@pytest.mark.parametrize("mode", probe_fma_fusion.MODES)
def test_chain_host_build_is_bit_for_bit(chain_host, mode):
    """The g++-built chain (``-ffp-contract=off``) equals the torch loop bit
    for bit at K = 64: the ``--fmad=false`` build's contract."""
    a, b = probe_fma_fusion.chain_inputs(128, "cpu")
    out = torch.empty((3, 128), dtype=torch.float32)
    rc = chain_host.fma_chain_host(a.data_ptr(), b.data_ptr(), out.data_ptr(), 128, 64,
                                   probe_fma_fusion.MODES.index(mode), 3)
    assert rc == 0
    want = probe_fma_fusion.chain_rows(a, b, 64, mode, 3)
    assert torch.equal(out, want)


def test_add_one_host_build_matches_plain(tmp_path):
    _gxx()
    lib = build.host_library(build.ADD_ONE, "", tmp_path)
    x = torch.linspace(-3, 3, 8 * 4 * 8 * 128, dtype=torch.float32).reshape(32, 8, 128)
    y = torch.empty_like(x)
    assert lib.add_one_host(x.data_ptr(), y.data_ptr(), x.numel()) == 0
    assert torch.equal(y, x + 1)


@pytest.fixture(scope="module")
def add_one_pdl_host(tmp_path_factory):
    _gxx()
    return build.host_library(build.ADD_ONE_PDL, "", tmp_path_factory.mktemp("add_one_pdl"))


@pytest.mark.parametrize("n", [4096, 4097, 4099, 1, 0])
def test_add_one_redesign_host_build_matches_plain(add_one_pdl_host, n):
    """``x + 1``'s redesign (float4 where both pointers are 16-byte aligned,
    a scalar tail, a grid stride) on the host's grid, bit for bit with
    ``x + 1`` at aligned and misaligned inputs and outputs; every element
    outside the n is left as it was."""
    g = torch.Generator().manual_seed(n)
    for x_off, y_off in ((0, 0), (1, 1), (0, 2), (3, 0)):
        x = torch.randn(n + x_off, generator=g)[x_off:]
        ybuf = torch.full((n + y_off + 1,), float("nan"))
        y = ybuf[y_off:y_off + n]
        assert add_one_pdl_host.add_one_pdl_host(x.data_ptr(), y.data_ptr(), n,
                                                 probe_launch_overhead.THREADS,
                                                 probe_launch_overhead.PER_SM, 1) == 0
        assert torch.equal(y, x + 1), (n, x_off, y_off)
        assert torch.isnan(ybuf[:y_off]).all() and torch.isnan(ybuf[y_off + n:]).all()


def test_add_one_redesign_host_build_refuses_bad_shapes(add_one_pdl_host):
    x, y = torch.zeros(8), torch.zeros(8)
    for n, threads, per_sm in ((-1, 256, 2), (8, 0, 2), (8, 100, 2), (8, 2048, 2), (8, 256, 0)):
        assert add_one_pdl_host.add_one_pdl_host(x.data_ptr(), y.data_ptr(), n, threads, per_sm,
                                                 1) == 1


def test_add_one_wrappers_on_the_cpu():
    """Both designs' wrappers run the plain version on CPU tensors, count
    no launch and refuse a meta tensor."""
    x = torch.linspace(-2, 2, 4099)
    before = dict(common.launches)
    for fn in (probe_launch_overhead.add_one, probe_launch_overhead.add_one_one_element):
        y = torch.empty_like(x)
        fn(x, y)
        assert torch.equal(y, x + 1)
        with pytest.raises(ValueError):
            fn(torch.zeros(4, device="meta"), torch.zeros(4, device="meta"))
    probe_launch_overhead.add_one(x, y, pdl=False)
    assert torch.equal(y, x + 1) and dict(common.launches) == before
    assert build.record_name(build.ADD_ONE_PDL) == "add_one_pdl"
    assert probe_launch_overhead.ONE_ELEMENT == "add_one[one-element]"


def test_wrappers_refuse_bad_inputs():
    s = H.torch_env()._s
    q = torch.zeros((s.nq, 100))
    blocks = [q, torch.zeros((s.nv, 100)), torch.zeros((s.nu, 100)), torch.zeros((s.ndr, 100))]
    with pytest.raises(ValueError, match="multiple of 128"):
        common.physics_probe(s, 1, blocks, common.empty_outputs(s, 100, "cpu"))
    blocks = [torch.zeros((n, 128)) for n in (s.nq, s.nv, s.nu, s.ndr)]
    with pytest.raises(ValueError, match="threads"):
        common.physics_probe(s, 1, blocks, common.empty_outputs(s, 128, "cpu"), threads=96)
    with pytest.raises(ValueError):  # row-major blocks given as block-major
        common.physics_probe(s, 1, blocks, common.empty_outputs(s, 128, "cpu"),
                             layout=common.BLOCK_MAJOR)
    a, b = probe_fma_fusion.chain_inputs(8, "cpu")
    with pytest.raises(ValueError):
        probe_fma_fusion.fma_chain(a, b, torch.empty(2, 8), 4, "fma", 2, False)
    with pytest.raises(ValueError):
        probe_launch_overhead.add_one(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError):
        probe_launch_overhead.add_one_one_element(torch.zeros(4), torch.zeros(4)[::1].double())


@pytest.mark.parametrize("probe", PROBES, ids=[p.__name__.rsplit(".", 1)[1] for p in PROBES])
def test_probe_cli_needs_a_card(probe):
    with pytest.raises(SystemExit) as e:
        probe.main([])
    assert "no CUDA device found" in str(e.value)
