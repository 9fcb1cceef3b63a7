"""Whole runs of ``portbench/run.py`` on tiny cells added as files: the
harness finds a new cell, configuration and metric by name; a sound run is
correct (and loads no module of JAX or of the JAX package: the run exits
with 2 if it does); each fault a cell can have, planted where the answer
is produced, makes ``correct`` false. The look for a card is skipped
(``--allow-cpu``); the kernels run their plain versions. The training
driver can have three: a step that leaves the weights unchanged, half the
batch left out with the mean over the rest, an altered reward; the
rollout driver two: an env step that returns its input state, an altered
reward (it takes no mean). Neither exchanges anything between chips.

The reference with its env step rounded through bfloat16 in the program's
place (the control) is not correct. On the card (``cuda`` marker): each
cell as committed runs with a short window and is correct, and its two
controls, the reference with TF32 products or with its env step rounded
through bfloat16 in the program's place, are not.
"""

from __future__ import annotations

import json
import os
import sys

import pytest

from conftest import REPO, run_cell


def test_sound_runs_are_correct(tiny_checkout):
    for cell in ("tiny.rollout", "tiny.train"):
        rc, result, err = run_cell(tiny_checkout, "--workload", cell, "--seed", "3000000019",
                                   "--seconds", "0.1", "--trace", "0", "--allow-cpu")
        assert rc == 0, err[-3000:]
        assert result["correct"] is True, err[-3000:]
        assert list(result)[-1] == "checks"
        assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell,fault", [("tiny.rollout", "unchanged"),
                                        ("tiny.rollout", "altered"),
                                        ("tiny.train", "unchanged"),
                                        ("tiny.train", "half_batch"),
                                        ("tiny.train", "altered")])
def test_faults_make_correct_false(tiny_checkout, cell, fault):
    rc, result, err = run_cell(tiny_checkout, "--workload", cell, "--seed", "2147483651",
                               "--seconds", "0.1", "--trace", "0", "--allow-cpu",
                               "--fault", fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.parametrize("cell", ["tiny.rollout", "tiny.train"])
def test_bf16_control_is_not_correct(tiny_checkout, cell):
    """The reference with its env step rounded through bfloat16, in the
    program's place."""
    rc, result, err = run_cell(tiny_checkout, "--workload", cell, "--seed", "2147483661",
                               "--seconds", "0.1", "--trace", "0", "--allow-cpu",
                               "--control", "bf16")
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def test_a_cell_added_as_files_is_found(tiny_checkout):
    """A throwaway metric file and its entry: found by name, no edit."""
    bench = os.path.join(tiny_checkout, "portbench")
    with open(os.path.join(bench, "metrics", "units.tiny.py"), "w") as f:
        f.write("def read(run):\n    return float(run.window.units)\n")
    path = os.path.join(tiny_checkout, "BENCHMARK.json")
    manifest = json.load(open(path))
    manifest["end_to_end"].append({"name": "units.tiny", "unit": "units", "better": "higher",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["tiny.rollout"]})
    json.dump(manifest, open(path, "w"))
    rc, result, err = run_cell(tiny_checkout, "--workload", "tiny.rollout", "--seed", "5",
                               "--seconds", "0.1", "--trace", "0", "--allow-cpu")
    assert rc == 0, err[-3000:]
    assert result["metrics"]["units.tiny"]["value"] == result["attempted"]


def test_no_card_no_result(tiny_checkout):
    rc, result, err = run_cell(tiny_checkout, "--workload", "tiny.rollout", "--seed", "5",
                               "--seconds", "0.1", "--trace", "0")
    if "no CUDA device" in err:
        assert rc != 0 and result is None


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's files alone."""
    import shutil
    import subprocess

    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "run8.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["run8.train", "default.rollout"])
def test_cells_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, result, err = run_cell(REPO, "--workload", cell, "--seed", "2147483693", "--seconds",
                               "2", "--trace", "0", timeout=1500)
    assert rc == 0 and result["correct"] is True, err[-3000:]
    for control in ("tf32", "bf16"):
        rc, result, err = run_cell(REPO, "--workload", cell, "--seed", "2147483693", "--seconds",
                                   "2", "--trace", "0", "--control", control, timeout=1500)
        assert rc == 0 and result["correct"] is False, (control, err[-3000:])
