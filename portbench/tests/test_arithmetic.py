"""The metric arithmetic on synthetic inputs: the window's rates and its
percentile over all units, the roofline and MFU from frozen counts, and
the trace's reduction on fake profiler events."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from conftest import BENCH, REPO

from portbench import counts, harness, tracing


class FakeClock(harness.Clock):
    """Marks from a list of host times (s), read in turn."""

    def __init__(self, times):
        super().__init__(cuda=False)
        self.times = list(times)

    def mark(self):
        return self.times.pop(0)


def test_window_units_and_rate():
    # seconds=0: one unit, then the window closes; its time runs from the
    # window's start mark to the unit's end mark
    clock = FakeClock([0.0, 0.125])
    w = harness.run_window(lambda i: None, 1000, 0.0, clock)
    assert w.units == 1 and w.env_steps == 1000
    assert w.unit_ms == pytest.approx([125.0]) and w.seconds == pytest.approx(0.125)


def test_percentile_over_all_units():
    xs = list(range(1, 201))  # 200 units
    assert harness.percentile(xs, 95) == pytest.approx(190.05)
    assert harness.percentile([5.0], 95) == 5.0
    assert harness.percentile([1.0, 2.0], 50) == 1.5


def test_rates_from_readers():
    w = harness.Window(seconds=2.0, unit_ms=[1000.0, 1000.0], env_steps=327680)
    run = SimpleNamespace(window=w, setup_s=12.5)
    assert harness.reader("train_sps")(run) == 163840.0
    assert harness.reader("rollout_sps")(run) == 163840.0
    assert harness.reader("setup_s")(run) == 12.5
    w = harness.Window(seconds=20.0, unit_ms=[float(i) for i in range(1, 201)], env_steps=1)
    assert harness.reader("unroll_ms_p95")(SimpleNamespace(window=w)) == pytest.approx(190.05)


def _counts(name):
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))["frozen_counts"]


def test_roofline_from_frozen_counts():
    c = _counts("default")
    ops = c["kernels"]["k3"]["float_ops_per_env_step"]
    # 16384 env steps whose least time is 16384 * ops / 67e12 s, run in 4x that
    least = 16384 * ops / harness.PEAK_FP32_FLOPS
    trace = {"device_us": {"wrapped_step_team_kernel": 4 * least * 1e6, "other": 9.0}}
    assert counts.roofline_pct(c, "k3", trace, 16384) == pytest.approx(25.0)
    assert counts.roofline_pct(c, "k3", {"device_us": {"other": 1.0}}, 16384) is None


def test_mfu_from_frozen_counts():
    c = _counts("run8")
    train = json.load(open(os.path.join(BENCH, "configs", "run8.json")))["experiment"]["train"]
    n = c["networks"]
    assert n["policy_flops_per_sample"] == 2 * (72 * 128 + 3 * 128 * 128 + 128 * 24)
    sgd = counts.sgd_flops(c, train)
    assert sgd == pytest.approx(128 * 3 * (5120 * (n["policy_flops_per_sample"]
                                                   + n["value_flops_per_sample"])
                                           + 256 * n["value_flops_per_sample"]))
    flops = counts.rollout_flops(c, 163840) + sgd
    assert counts.mfu_pct(flops, 1.0) == pytest.approx(100 * flops / 67e12)


def _event(name, start, end, device="CUDA", annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=getattr(DeviceType, device),
                           is_user_annotation=annotation)


def test_summarize_fake_events():
    events = [
        _event("pb.sgd", 0.0, 100.0, device="CPU"),
        _event("pb.rollout", 100.0, 200.0, device="CPU"),
        _event("cudaLaunchKernel", 10.0, 11.0, device="CPU"),
        _event("cudaLaunchKernel", 20.0, 21.0, device="CPU"),
        _event("cudaLaunchKernel", 150.0, 151.0, device="CPU"),
        _event("k_a", 12.0, 30.0),
        _event("k_b", 25.0, 40.0),  # overlaps k_a: busy 12-40
        _event("k_c", 160.0, 170.0),
        _event("pb.sgd", 12.0, 170.0, annotation=True),  # a device span: not busy time
    ]
    s = tracing.summarize(events, window_ms=0.2)
    assert s["busy_ms"] == pytest.approx((28.0 + 10.0) / 1000.0)
    assert s["launches"] == {"k_a": 1, "k_b": 1, "k_c": 1}
    assert s["span_launches"] == {"pb.sgd": 2, "pb.rollout": 1}
    # the one gap (40 -> 160 us) began while the host was in pb.sgd
    assert s["idle_by_span_us"] == {"pb.sgd": pytest.approx(120.0)}
    b = tracing.breakdown(s)
    assert b["device_ops"][0] == ["k_a", pytest.approx(18e-6)]
    assert b["idle_gaps"] == [["pb.sgd", pytest.approx(120e-6)]]


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "puppax_torch_like", types.ModuleType("x"))
    assert "puppax_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "puppax.env", types.ModuleType("y"))
    assert "puppax.env" in harness.forbidden_modules()


def test_repo_is_where_the_tests_think():
    assert os.path.exists(os.path.join(REPO, "BENCHMARK.json"))
