"""The launch and host-overhead probes (``profile_overhead``,
``profile_scan``, ``profile_boundary``, ``probe_degradation``) on the CPU.

- ``csrc/probe_copy.cuh`` built with g++ against its plain version
  (``common.copy_rows``), each operand set, bit for bit: the
  element-parallel copy (every thread of its grid in turn) at B = 4096,
  at B = 130 (a count that is no multiple of 4) and on blocks offset by
  one float (no 16-byte alignment: the scalar path), and its one-thread
  copy beside it; the card's build waits for ``tests/test_torch_cuda.py``.
- The plain copy against the TPU's copy kernels: the dev scripts run at
  import, so their kernel bodies (``dev/profile_scan.py:77-79``,
  ``dev/profile_overhead.py:88-94,112-116``) are restated here under
  ``pl.pallas_call(..., interpret=True)`` on ``puppax``'s tile blocks at
  B = 1024; q, v and the caches exactly (the sink row is the port's own).
- The boundary variants at B = 8: rows-resident and transpose-bound (and
  the splice) bit for bit, transpose-only as its inputs times 1.0000001,
  the splice's q and v against JAX's XLA ``pipeline_step`` at qpos 5e-5 /
  scaled qvel 5e-4, as ``tests/test_torch_physics_step.py`` holds K1.
- Every degradation stage's setup on the CPU (nothing is timed here),
  ``probe_degradation.run``'s orchestration with stand-in stages (every
  setup before the first window, the windows in stage order), the
  scan probe's comparison of output nests, the wrappers' checks and the
  four command lines without a card.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.physics import pipeline as jpipe
from puppax.physics import soa as jsoa
from puppax_torch.kernels import build
from puppax_torch.probes import common, probe_degradation, profile_boundary
from puppax_torch.probes import profile_overhead, profile_scan
from puppax_torch.train.acting import Transition

torch.set_num_threads(1)

PROBES = (profile_overhead, profile_scan, profile_boundary, probe_degradation)
ROWS = {"nq": 19, "nv": 18, "nu": 12, "ndr": 166, "ncache": 351}  # K1's blocks


def _copy_inputs(B: int, seed: int):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.uniform(-2, 2, (ROWS[k], B)).astype(np.float32))
            for k in ("nq", "nv", "nu", "ndr")]


def _ins(mode, blocks):
    return blocks[: {"q": 1, "min": 2, "full": 4}[mode]]


@pytest.fixture(scope="module")
def copy_host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the probe's C cannot be built on the host")
    return build.host_library(build.PROBE_COPY, "", tmp_path_factory.mktemp("copy"))


@pytest.mark.parametrize("mode", common.COPY_MODES)
def test_copy_host_build_is_bit_for_bit(copy_host, mode):
    """The g++-built copy (its host loop) equals ``copy_rows`` and the CPU
    wrapper bit for bit, at a B that is no multiple of 128."""
    ins = _ins(mode, _copy_inputs(200, seed=1))
    got = common.copy_outputs(mode, ins, ROWS["ncache"])
    pad = [None] * (4 - len(ins))
    ptrs = [None if t is None else t.data_ptr() for t in list(ins) + pad + list(got) + pad]
    rows = [x.shape[0] for x in ins] + [0] * len(pad) + [ROWS["ncache"] if mode == "full" else 0]
    assert copy_host.probe_copy_host(*ptrs, 200, common.COPY_MODES.index(mode), *rows) == 0
    want = common.copy_outputs(mode, ins, ROWS["ncache"])
    common.copy_rows(mode, ins, want)
    assert common.compare_exact(got, want) == (0.0, 0)
    wrapped = common.copy_outputs(mode, ins, ROWS["ncache"])
    common.copy_probe(mode, ins, wrapped)
    assert common.compare_exact(wrapped, want) == (0.0, 0)
    if mode == "full":
        sink = torch.zeros(200)
        for x in ins[2:]:
            for r in x:
                sink = sink + r
        assert torch.equal(want[3][0], sink) and torch.equal(want[2], ins[0][:1].expand(351, -1))
    assert copy_host.probe_copy_host(*ptrs, 200, 3, *rows) != 0  # no such mode


def _offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x`` copied into a contiguous block that starts ``offset`` floats
    into its storage."""
    buf = torch.empty(x.numel() + offset)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def _host_copy(fn, mode, ins, outs):
    pad = [None] * (4 - len(ins))
    ptrs = [None if t is None else t.data_ptr() for t in list(ins) + pad + list(outs) + pad]
    rows = [x.shape[0] for x in ins] + [0] * len(pad) + [outs[2].shape[0] if mode == "full" else 0]
    assert fn(*ptrs, ins[0].shape[1], common.COPY_MODES.index(mode), *rows) == 0


@pytest.mark.parametrize("B,offset", [(4096, 0), (130, 0), (4096, 1)],
                         ids=["4096", "130", "4096-offset"])
@pytest.mark.parametrize("mode", common.COPY_MODES)
def test_element_parallel_copy_is_bit_for_bit(copy_host, mode, B, offset):
    """The element-parallel copy's g++ build (float4 units where the bases
    are 16-byte aligned and the count a multiple of 4, one float a thread
    elsewhere; the sink one thread per env) and the one-thread copy's, both
    equal to ``copy_rows`` bit for bit."""
    ins = [_offset(x, offset) for x in _ins(mode, _copy_inputs(B, seed=4))]
    assert all(x.data_ptr() % 16 == 4 * offset for x in ins)
    want = common.copy_outputs(mode, ins, ROWS["ncache"])
    common.copy_rows(mode, ins, want)
    one_thread = build._bind(copy_host, build.PROBE_COPY, False, "probe_copy_one_thread_host")
    for fn in (copy_host.probe_copy_host, one_thread):
        got = [_offset(torch.full_like(x, np.nan), offset) for x in want]
        _host_copy(fn, mode, ins, got)
        assert common.compare_exact(got, want) == (0.0, 0), fn


def _pallas_copy(mode, blocks):
    """The TPU probes' copy kernels, restated, in interpret mode on
    ``(rows, B)`` numpy blocks; their outputs as ``(rows, B)``."""
    import jax.experimental.pallas as pl

    B = blocks[0].shape[1]
    nq, nv, ncache = ROWS["nq"], ROWS["nv"], ROWS["ncache"]

    def copy_q(q_ref, qo):  # dev/profile_scan.py:77-79
        for i in range(nq):
            qo[i] = q_ref[i] + 1e-7

    def copy_min(q_ref, v_ref, qo, vo):  # dev/profile_overhead.py:112-116
        for i in range(nq):
            qo[i] = q_ref[i] + 1e-7
        for i in range(nv):
            vo[i] = v_ref[i] + 1e-7

    def copy_full(q_ref, v_ref, c_ref, dr_ref, qo, vo, co):  # dev/profile_overhead.py:88-94
        for i in range(nq):
            qo[i] = q_ref[i] + 1e-7
        for i in range(nv):
            vo[i] = v_ref[i] + 1e-7
        for i in range(ncache):
            co[i] = q_ref[0]

    kernel, out_rows = {"q": (copy_q, (nq,)), "min": (copy_min, (nq, nv)),
                        "full": (copy_full, (nq, nv, ncache))}[mode]

    def spec(rows):
        return pl.BlockSpec((rows, jsoa.SUB, jsoa.LANE), lambda i: (0, i, 0))

    call = jax.jit(pl.pallas_call(
        kernel, grid=(B // jsoa.TILE_B,),
        in_specs=[spec(x.shape[0]) for x in blocks],
        out_specs=[spec(n) for n in out_rows],
        out_shape=[jax.ShapeDtypeStruct((n, B // jsoa.LANE, jsoa.LANE), jnp.float32)
                   for n in out_rows],
        interpret=True,
    ))
    outs = call(*[jsoa._to_tiles(jnp.asarray(x.T), B) for x in blocks])
    return [np.asarray(jsoa._from_tiles(o, B)).T for o in outs]


@pytest.mark.parametrize("mode", common.COPY_MODES)
def test_plain_copy_matches_the_tpu_kernels(mode):
    ins = _ins(mode, _copy_inputs(jsoa.TILE_B, seed=2))
    want = _pallas_copy(mode, [x.numpy() for x in ins])
    got = common.copy_outputs(mode, ins, ROWS["ncache"])
    common.copy_rows(mode, ins, got)
    for g, w in zip(got, want):  # the sink row, the port's own, has no TPU twin
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def boundary_setup():
    """The port's env (1 substep), in-cap random states of the nominal model
    (``tests/test_torch_physics_step.py``'s), and JAX's XLA pipeline_step on
    them."""
    jenv, tenv = H.jax_env(), H.torch_env()
    dr = tenv.dr_rows(H.B)
    blocks = H.physics_step_blocks(tenv.model, dr.numpy(), np.random.RandomState(0))
    q, v, c = (b.T for b in blocks[:3])
    m = jenv.model
    want = jax.jit(jax.vmap(lambda qp, qv, ct: jpipe.pipeline_step(
        m, jpipe._zeros_state(m, qp, qv), ct, 1)))(q, v, c)
    return tenv, [*H.to_torch(blocks[:3]), dr], jax.tree_util.tree_map(np.asarray, want)


def test_boundary_variants_agree(boundary_setup):
    """Two steps of rows-resident, transpose-bound and the splice from the
    same states give the same q and v bit for bit; one splice step meets
    JAX's XLA pipeline_step; transpose-only multiplies by 1.0000001."""
    env, (q, v, ctrl, dr), want = boundary_setup
    s, B = env._cv_step.s, q.shape[1]
    qb, vb = q.t().contiguous(), v.t().contiguous()
    ref = profile_boundary.window(profile_boundary.rows_resident(s, 1, ctrl, dr), (q, v), 2)
    splice = profile_boundary.splice(env, ctrl.t().contiguous(), dr)
    for name, step in (("transpose_bound", profile_boundary.transpose_bound(s, 1, ctrl, dr)),
                       ("splice", splice)):
        got = profile_boundary.window(step, (qb, vb), 2)
        assert all(g.shape == (B, n) for g, n in zip(got, (s.nq, s.nv))), name
        assert common.compare_exact([x.t() for x in got], ref) == (0.0, 0), name
    one = splice(qb, vb)
    np.testing.assert_allclose(one[0].numpy(), want.qpos, atol=5e-5, rtol=0, err_msg="qpos")
    scale = np.maximum(1.0, np.abs(want.qvel).max(axis=1, keepdims=True))
    np.testing.assert_allclose(one[1].numpy() / scale, want.qvel / scale, atol=5e-4, rtol=0,
                               err_msg="scaled qvel")
    cache = torch.linspace(-1, 1, B * s.ncache).reshape(B, s.ncache)
    out = profile_boundary.transpose_only(qb, vb, cache)
    for o, x in zip(out, (qb, vb, cache)):
        assert o.is_contiguous() and torch.equal(o, x * profile_boundary.SCALE)


@pytest.mark.parametrize("stage", sorted(probe_degradation.STAGES))
def test_degradation_stage_setup_runs_on_cpu(stage):
    probe_degradation.setup(stage, "cpu")


def test_degradation_refuses_an_unknown_stage():
    with pytest.raises(ValueError, match="stage 12"):
        probe_degradation.setup(12, "cpu")


_FAKE_STAGE = """
import json, sys, time
stage = int(sys.argv[sys.argv.index("--stage") + 1])
assert "--wait" in sys.argv
time.sleep(0.05 * (12 - stage))  # the late stages ready first
if stage == FAIL:
    sys.exit("no setup")
with open(LOG, "a") as f:
    f.write(f"ready {stage}\\n")
print("ready", flush=True)
sys.stdin.readline()
with open(LOG, "a") as f:
    f.write(f"window {stage}\\n")
print(json.dumps(dict(stage=stage, what="", eager_us=stage, graph_us=0.5,
                      launches={"copy_q": 150})), flush=True)
"""


@pytest.mark.parametrize("fail", [None, 5])
def test_degradation_sets_up_every_stage_before_any_window(tmp_path, monkeypatch, fail):
    """``probe_degradation.run``'s orchestration, its stages a stand-in
    module (the card's part stubbed): every stage's setup is done before
    the first window, the windows run in stage order, the lines and
    launches are collected; a stage that exits during its setup fails the
    run before any window."""
    from types import SimpleNamespace

    log = tmp_path / "log.txt"
    (tmp_path / "fake_stage.py").write_text(
        _FAKE_STAGE.replace("FAIL", repr(fail)).replace("LOG", repr(str(log))))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(probe_degradation, "MODULE", "fake_stage")
    monkeypatch.setattr(probe_degradation.build, "probe_copy_library", lambda: None)
    monkeypatch.setattr(probe_degradation.common, "nvidia_smi", lambda: "")
    monkeypatch.setattr(probe_degradation, "window_us", lambda device: (1.0, 0.5))
    monkeypatch.setattr(probe_degradation, "torch", SimpleNamespace(
        device=lambda *a: "cpu", ones=lambda *a, **k: torch.ones(1)))
    monkeypatch.setattr(common, "launches", type(common.launches)())
    stages = sorted(probe_degradation.STAGES)
    if fail is not None:
        with pytest.raises(RuntimeError, match="stage 5 did not finish its setup"):
            probe_degradation.run(timeout=60)
        assert "window" not in log.read_text()
        return
    results = probe_degradation.run(timeout=60)
    lines = log.read_text().split()
    events = list(zip(lines[::2], map(int, lines[1::2])))
    assert sorted(s for what, s in events[:12] if what == "ready") == stages
    assert [s for what, s in events[12:]] == stages and all(w == "window" for w, _ in events[12:])
    assert [results[s]["eager_us"] for s in stages] == stages and "sync" in results
    assert common.launches["copy_q"] == 150 * len(stages)


def test_output_nests_compare_bit_for_bit():
    """``profile_scan.differing_leaves``, which holds the graphed unroll
    against the eager one: equal nests (NaN included) give no path; a
    changed bit, a shape, a dtype or a missing key each name their path."""
    x = torch.tensor([1.0, float("nan"), 3.0])

    def nest(obs, extras):
        return ({"a": obs, "b": (obs * 2,)},
                Transition(observation=obs, action=obs, reward=obs, discount=obs,
                           next_observation=obs, truncation=obs, policy_extras=extras))

    base = nest(x, {"log_prob": x})
    assert profile_scan.differing_leaves(base, nest(x.clone(), {"log_prob": x.clone()})) == []
    bumped = x.clone()
    bumped[0] = torch.nextafter(bumped[0], torch.tensor(2.0))
    assert profile_scan.differing_leaves(base, nest(x, {"log_prob": bumped})) == [
        "[1].policy_extras['log_prob']"]
    assert profile_scan.differing_leaves(base, nest(x, {"log_prob": x[:2]})) != []
    assert profile_scan.differing_leaves(base, nest(x, {"log_prob": x.double()})) != []
    assert profile_scan.differing_leaves(base, nest(x, {})) == ["[1].policy_extras['log_prob']"]
    assert len(dict(profile_scan.leaves(base))) == 9


def test_copy_wrapper_refuses_bad_inputs():
    q, v, c, d = _copy_inputs(256, seed=3)
    full = common.copy_outputs("full", (q, v, c, d), 351)
    with pytest.raises(ValueError, match="mode"):
        common.copy_probe("all", (q,), full[:1])
    with pytest.raises(ValueError, match="expected 2 input"):
        common.copy_probe("min", (q,), full[:1])
    with pytest.raises(ValueError):  # another B
        common.copy_probe("min", (q, v[:, :128].contiguous()), full[:2])
    with pytest.raises(ValueError):
        common.copy_probe("q", (q.double(),), full[:1])
    with pytest.raises(ValueError):
        common.copy_probe("q", (q.t().contiguous().t(),), full[:1])
    with pytest.raises(ValueError):  # a sink of two rows
        common.copy_probe("full", (q, v, c, d), [*full[:3], torch.empty(2, 256)])
    with pytest.raises(ValueError, match="unsupported device"):
        common.copy_probe("q", (q.to("meta"),), [full[0].to("meta")])
    assert [common.copy_name("full", n) for n in (4096, 128)] == ["copy_full",
                                                                  "copy_full_one_block"]
    assert build.record_name(build.PROBE_COPY) == "probe_copy"


@pytest.mark.parametrize("probe", PROBES, ids=[p.__name__.rsplit(".", 1)[1] for p in PROBES])
def test_probe_cli_needs_a_card(probe):
    with pytest.raises(SystemExit) as e:
        probe.main([])
    assert "no CUDA device found" in str(e.value)


def test_degradation_stage_cli_needs_a_card():
    with pytest.raises(SystemExit) as e:
        probe_degradation.main(["--stage", "3"])
    assert "no CUDA device found" in str(e.value)
