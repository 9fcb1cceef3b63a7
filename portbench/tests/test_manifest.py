"""BENCHMARK.json against the benchmark's contract and against the files
the harness finds by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*(_dim|_rank)$|"
                   r".*(size|sizes|expansion|per_tok).*")


@pytest.fixture(scope="module")
def manifest():
    return json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def test_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    assert len({n for g, n in names if g == "workloads"}) == len(manifest["workloads"])


def test_end_to_end(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_one_metric_reported_by_its_cells(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all("\n" not in layer for layer in layers)


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        e2e = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in manifest["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert per
        assert w["chips"] in (1, 4)


def test_files_found_by_name(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in configs.values():
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.load(open(os.path.join(REPO, c["file"])))
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.match(k)]
        assert set(data["frozen_counts"]["kernels"]["k3"]) >= {
            "trace_name", "float_ops_per_env_step", "bytes_per_env_step"}
    used = set()
    for w in manifest["workloads"]:
        traffic = json.load(open(os.path.join(BENCH, "workloads", f"{w['name']}.json")))
        assert traffic["config"] == w["config"] and w["config"] in configs
        assert os.path.exists(os.path.join(BENCH, "drivers", f"{traffic['driver']}.py"))
        used.add(w["config"])
    assert used == set(configs)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]


def test_layers_named_in_perf_md(manifest):
    text = open(os.path.join(REPO, "PERF.md")).read()
    for m in manifest["per_layer"]:
        assert m["layer"] in text, m["layer"]
