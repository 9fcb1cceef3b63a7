"""Fixtures of the benchmark's own tests: a throwaway checkout with tiny
cells added as files (the harness finds them by name), and a runner of
``portbench/run.py`` in it.

Run them from the repository's root: ``python -m pytest portbench/tests``.
Tests that need the card carry the ``cuda`` marker and skip without one.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path[:0] = [REPO, os.path.join(BENCH, "reference")]

# tiny sizes a CPU test holds: the published configurations' keys, with the
# training sizes and widths cut (the plain versions of the kernels run here)
TINY_TRAIN = dict(num_envs=4, batch_size=4, num_minibatches=2, num_updates_per_batch=1,
                  unroll_length=2, policy_hidden_layer_sizes=[16, 16],
                  value_hidden_layer_sizes=[16, 16])


def add_tiny_cells(root: str) -> None:
    """Add ``tiny.rollout`` and ``tiny.train`` on a tiny flat configuration
    to the checkout at ``root``: one config file, two traffic files, their
    entries in BENCHMARK.json, and the existing metrics' ``workloads``."""
    bench = os.path.join(root, "portbench")
    c = json.load(open(os.path.join(bench, "configs", "default.json")))
    c["name"] = "tiny"
    c["experiment"]["train"].update(TINY_TRAIN)
    json.dump(c, open(os.path.join(bench, "configs", "tiny.json"), "w"))
    manifest = json.load(open(os.path.join(root, "BENCHMARK.json")))
    manifest["configs"].append(dict(manifest["configs"][0], name="tiny",
                                    file="portbench/configs/tiny.json"))
    for cell, base in (("tiny.rollout", "default.rollout"), ("tiny.train", "run8.train")):
        w = json.load(open(os.path.join(bench, "workloads", f"{base}.json")))
        w.update(config="tiny", num_envs=4, check_envs=2, tail_units=1)
        if w["driver"] == "rollout":
            w.update(unroll_length=2, warmup_unrolls=1, check_unrolls=1, check_unroll_range=[0, 1])
        else:
            w.update(check_steps=2, check_window_range=[1, 2])
        json.dump(w, open(os.path.join(bench, "workloads", f"{cell}.json"), "w"))
        manifest["workloads"].append({"name": cell, "config": "tiny", "traffic": "tiny",
                                      "chips": 1, "why": "a test's tiny cell"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if base in m.get("workloads", ()):
                m["workloads"].append(cell)
    json.dump(manifest, open(os.path.join(root, "BENCHMARK.json"), "w"))


def copy_checkout(dst: str) -> str:
    """BENCHMARK.json and portbench/ copied, the program linked."""
    shutil.copytree(BENCH, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(REPO, "puppax_torch"), os.path.join(dst, "puppax_torch"))
    return dst


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory):
    root = copy_checkout(str(tmp_path_factory.mktemp("checkout")))
    add_tiny_cells(root)
    return root


def run_cell(root: str, *args: str, timeout: int = 900):
    """``portbench/run.py`` in ``root``: (exit code, the result or None,
    stderr)."""
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "portbench/run.py", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr
