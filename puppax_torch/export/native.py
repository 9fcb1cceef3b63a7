"""ctypes bridge to the native policy runtime (``native/policy_runtime.cc``).

Counterpart of ``puppax/export/native.py`` (``build_native_runtime`` :22,
``NativePolicy`` :42-120, the same API): Python code, and the round-trip
checks of the tests and ``chip_smoke.py``, drive the same C++ forward pass
the robot runs, so a policy the port trained is shown to be consumable by
the native runtime.

``runtime_forward`` is the runtime's float32 forward pass in numpy, the
yardstick that tells the runtime's rounding from a fault.

``build_native_runtime`` compiles the runtime's source with g++ and the
flags of ``native/Makefile`` into
``build/puppax_torch_native/<sha256 of source + compiler + flags>/`` in
the checkout (a finished library there is reused). It never runs ``make``,
never writes into ``native/`` and never loads a library from there; without
g++ it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from puppax_torch.kernels.build import REPO_ROOT

SOURCE = REPO_ROOT / "native" / "policy_runtime.cc"
BUILD_ROOT = REPO_ROOT / "build" / "puppax_torch_native"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")  # native/Makefile's
LIB_NAME = "libpuppax_policy.so"


def build_native_runtime(build_root=None, compiler: str = "g++") -> str:
    """Compile the runtime into ``<build_root>/<hash>/libpuppax_policy.so``
    (``BUILD_ROOT`` by default) unless it is there; returns its path."""
    cxx = shutil.which(compiler)
    if cxx is None:
        raise FileNotFoundError(f"{compiler} not found: the native runtime is built with it")
    source = SOURCE.read_text()
    digest = hashlib.sha256("\0".join([source, compiler, " ".join(CXX_FLAGS)]).encode())
    d = Path(build_root or BUILD_ROOT) / digest.hexdigest()
    lib = d / LIB_NAME
    if lib.exists():
        return str(lib)
    d.mkdir(parents=True, exist_ok=True)
    (d / SOURCE.name).write_text(source)
    tmp = d / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(d / SOURCE.name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (d / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"native runtime build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           + (proc.stdout + proc.stderr)[-4000:])
    os.replace(tmp, lib)
    return str(lib)


def runtime_forward(exported, observation) -> np.ndarray:
    """The runtime's forward pass (``policy_runtime.cc::Infer``) in numpy,
    in its float32 arithmetic and order: each layer's outputs start at the
    bias, add ``x[i] * kernel[i]`` for i in turn (one rounding per multiply
    and per add), then the activation; ``observation`` is ``(in,)`` or a
    batch ``(n, in)``. Where the JSON's folded weights are large (a
    normalizer std at its 1e-6 floor makes them 1e6 times the kernel's),
    this float32 evaluation parts from ``apply_exported_policy``'s float64
    one; the runtime follows this one."""
    activations = {
        "relu": lambda v: np.where(v > 0, v, np.float32(0)),
        "elu": lambda v: np.where(v > 0, v, np.expm1(np.minimum(v, np.float32(0)))),
        "tanh": np.tanh,
        "sigmoid": lambda v: np.float32(1) / (np.float32(1) + np.exp(-v)),
        "swish": lambda v: v / (np.float32(1) + np.exp(-v)),
        "silu": lambda v: v / (np.float32(1) + np.exp(-v)),
        "linear": lambda v: v,
    }
    x = np.atleast_2d(np.asarray(observation, np.float32))
    for layer in exported["layers"]:
        kernel = np.asarray(layer["weights"][0], np.float32)
        y = np.repeat(np.asarray(layer["weights"][1], np.float32)[None], len(x), 0)
        for i in range(kernel.shape[0]):
            y += x[:, i, None] * kernel[i]
        x = activations[layer["activation"]](y).astype(np.float32)
    return x.reshape(np.shape(observation)[:-1] + x.shape[-1:])


_FLOATS = ctypes.POINTER(ctypes.c_float)


class NativePolicy:
    """A policy loaded into the C++ runtime."""

    def __init__(self, json_path: str, lib_path: Optional[str] = None):
        lib = ctypes.CDLL(lib_path or build_native_runtime())
        lib.puppax_policy_load.restype = ctypes.c_void_p
        lib.puppax_policy_load.argtypes = [ctypes.c_char_p]
        lib.puppax_policy_in_dim.argtypes = [ctypes.c_void_p]
        lib.puppax_policy_out_dim.argtypes = [ctypes.c_void_p]
        lib.puppax_policy_infer.argtypes = [ctypes.c_void_p, _FLOATS, _FLOATS]
        lib.puppax_policy_free.argtypes = [ctypes.c_void_p]
        lib.puppax_policy_gait_enabled.argtypes = [ctypes.c_void_p]
        lib.puppax_policy_gait_frequency.argtypes = [ctypes.c_void_p]
        lib.puppax_policy_gait_frequency.restype = ctypes.c_double
        lib.puppax_policy_reset_clock.argtypes = [ctypes.c_void_p]
        lib.puppax_policy_infer_clocked.argtypes = [ctypes.c_void_p, _FLOATS, _FLOATS]
        self._lib = lib
        self._handle = lib.puppax_policy_load(str(json_path).encode())
        if not self._handle:
            raise ValueError(f"native runtime rejected policy: {json_path}")
        self.in_dim = lib.puppax_policy_in_dim(self._handle)
        self.out_dim = lib.puppax_policy_out_dim(self._handle)
        self.gait_enabled = bool(lib.puppax_policy_gait_enabled(self._handle))
        self.gait_frequency = float(lib.puppax_policy_gait_frequency(self._handle))

    def _infer(self, fn, obs, width: int) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32)
        if obs.shape != (width,):
            raise ValueError(f"observation shape {obs.shape}, expected ({width},)")
        out = np.empty(self.out_dim, np.float32)
        if fn(self._handle, obs.ctypes.data_as(_FLOATS), out.ctypes.data_as(_FLOATS)) != 0:
            raise RuntimeError("native inference failed")
        return out

    def __call__(self, obs) -> np.ndarray:
        return self._infer(self._lib.puppax_policy_infer, obs, self.in_dim)

    def reset_clock(self):
        """Zero the runtime's free-running gait clock."""
        self._lib.puppax_policy_reset_clock(self._handle)

    def infer_clocked(self, obs) -> np.ndarray:
        """Gait-policy tick: pass the RAW obs history (in_dim - 2 floats);
        the runtime appends [cos, sin] of its clock and advances it
        (use-then-advance — tick 0 sees phase 0, like the env's reset)."""
        width = self.in_dim - 2 if self.gait_enabled else self.in_dim
        return self._infer(self._lib.puppax_policy_infer_clocked, obs, width)

    def close(self):
        if self._handle:
            self._lib.puppax_policy_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:
            pass
