"""``chip_smoke.py`` refuses to run where it cannot measure the card.

On a host without a CUDA device it must exit non-zero with a message that
no device was found, and print no result line; copied alone into a
directory without the repository it must fail as well.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=60, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )


def test_exits_nonzero_without_cuda():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _smoke_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zero_outputs(s, es, aux_rows, n=4):
    import torch

    naux = sum(k for _, k in aux_rows.values())
    return [torch.zeros(rows, n) for rows in (s.nq, s.nv, es.nenv_rows, 2, naux)]


@pytest.mark.parametrize("side", ["kernel", "plain"])
def test_compare_outputs_fails_on_nan(side):
    """A NaN in either the kernel's or the plain version's outputs fails
    the kernel-against-plain check, even where the error reads NaN."""
    import torch_port_helpers as H
    from puppax_torch.env import soa_env

    env = H.torch_env()
    aux_rows = soa_env.aux_row_map(env._es)
    got = _zero_outputs(env._s, env._es, aux_rows)
    want = [x.clone() for x in got]
    (got if side == "kernel" else want)[1][0, 2] = float("nan")
    with pytest.raises(AssertionError, match=f"{side} output block v"):
        _smoke_module().compare_outputs(env._s, env._es, aux_rows, got, want)


def test_compare_outputs_names_the_differing_env():
    import torch_port_helpers as H
    from puppax_torch.env import soa_env

    env = H.torch_env()
    aux_rows = soa_env.aux_row_map(env._es)
    got = _zero_outputs(env._s, env._es, aux_rows)
    want = [x.clone() for x in got]
    got[4][aux_rows["done"][0], 3] = 1.0
    per_block, differing, max_err = _smoke_module().compare_outputs(
        env._s, env._es, aux_rows, got, want
    )
    assert [b for b, _ in differing] == [3] and "aux row 1" in differing[0][1]
    assert per_block["aux"] == max_err == 1.0
