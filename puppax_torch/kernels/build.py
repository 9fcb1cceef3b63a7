"""Build and bind the generated kernels: nvcc for the card, g++ for tests.

The generated body and the launch shell are written to
``build/puppax_torch_kernels/<sha256 of source + flags>/`` in the
checkout, compiled into a shared library with a plain C interface, and
loaded with ``ctypes`` (every pointer and the stream as ``c_void_p``). A
finished library in that directory is reused; nothing is built at import.

``--fmad=false`` keeps the kernel's rounding equal to the plain version's
(no multiply-add contraction); contraction is a later performance lever.
``-Xptxas -v`` writes the registers, stack and spills of the kernel into
the build directory's ``build.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_ROOT = REPO_ROOT / "build" / "puppax_torch_kernels"
SHELL = Path(__file__).resolve().parents[1] / "csrc" / "wrapped_step.cuh"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC")

N_POINTERS = 13  # 8 input blocks + 5 output blocks

# (model statics, env statics, n_substeps, episode_length) -> loaded library
_LOADED: Dict[Tuple[int, int, int, int], Tuple[object, object, ctypes.CDLL]] = {}

# what the last build did: {"seconds": ..., "cached": ..., "dir": ...}
last_build: Dict[str, object] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (CUDA toolkit required to build kernels)")


def compile_library(body: str, compiler: Sequence[str], flags: Sequence[str],
                    out_root: Path, lib_name: str) -> Tuple[Path, bool, float]:
    """Compile the shell around ``body`` into ``<out_root>/<hash>/lib_name``.
    Returns (library path, whether it was cached, seconds spent)."""
    shell = SHELL.read_text()
    digest = hashlib.sha256(
        "\0".join([body, shell, " ".join(compiler), " ".join(flags)]).encode()
    ).hexdigest()
    d = Path(out_root) / digest
    lib = d / lib_name
    if lib.exists():
        return lib, True, 0.0
    d.mkdir(parents=True, exist_ok=True)
    (d / "wrapped_step_body.inc").write_text(body)
    (d / "wrapped_step.cuh").write_text(shell)
    unit = d / "wrapped_step_unit.cu"
    unit.write_text(
        '#define PUPPAX_WRAPPED_STEP_BODY "wrapped_step_body.inc"\n'
        '#include "wrapped_step.cuh"\n'
    )
    tmp = d / f".{lib_name}.{os.getpid()}.tmp"
    cmd = [*compiler, *flags, "-I", str(d), "-o", str(tmp), str(unit)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    (d / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr + f"\n{secs:.1f} s\n"
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({proc.returncode}): {' '.join(cmd)}\n"
            + (proc.stdout + proc.stderr)[-4000:]
        )
    os.replace(tmp, lib)
    return lib, False, secs


def _bind(lib: ctypes.CDLL, fn_name: str, with_stream: bool):
    fn = getattr(lib, fn_name)
    args = [ctypes.c_void_p] * N_POINTERS + [ctypes.c_int]
    if with_stream:
        args.append(ctypes.c_void_p)
    fn.argtypes = args
    fn.restype = ctypes.c_int
    return fn


def wrapped_step_library(s, es, n_substeps: int, episode_length: int) -> ctypes.CDLL:
    """The wrapped-step kernel for this configuration, built with nvcc for
    sm_90a at first use and cached for the process."""
    key = (id(s), id(es), int(n_substeps), int(episode_length))
    hit = _LOADED.get(key)
    if hit is not None:
        return hit[2]
    from puppax_torch.kernels import cgen

    t0 = time.perf_counter()
    body = cgen.wrapped_step_body(s, es, n_substeps, episode_length)
    gen_secs = time.perf_counter() - t0
    path, cached, secs = compile_library(
        body, [nvcc_path()], NVCC_FLAGS, BUILD_ROOT, "libwrapped_step.so"
    )
    lib = ctypes.CDLL(str(path))
    _bind(lib, "wrapped_step_launch", with_stream=True)
    last_build.clear()
    last_build.update(
        generate_seconds=gen_secs, compile_seconds=secs, cached=cached,
        dir=str(path.parent), lines=body.count("\n"),
    )
    _LOADED[key] = (s, es, lib)  # keeps s/es alive so their ids stay unique
    return lib


def host_library(body: str, out_root: Path, compiler: str = "g++") -> ctypes.CDLL:
    """The same generated source built for the CPU (``wrapped_step_host``)."""
    path, _, _ = compile_library(body, [compiler], GXX_FLAGS, out_root,
                                 "libwrapped_step_host.so")
    lib = ctypes.CDLL(str(path))
    _bind(lib, "wrapped_step_host", with_stream=False)
    return lib
