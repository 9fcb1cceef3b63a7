"""Build and bind the generated kernels: nvcc for the card, g++ for tests.

Each kernel is a generated body (``kernels/cgen.py``; for the team kernels
``kernels/team.py``) inside a hand-written launch shell (``csrc/*.cuh``,
which includes ``csrc/common.cuh``, and the team shells ``csrc/team.cuh``).
Body, shell and headers are written to
``build/puppax_torch_kernels/<sha256 of sources + compiler + flags>/`` in
the checkout, compiled into a shared library with a plain C interface, and
loaded with ``ctypes`` (every pointer and the stream as ``c_void_p``). A
finished library in that directory is reused; nothing is built at import.

``--fmad=false`` keeps the kernel's rounding equal to the plain version's
(no multiply-add contraction); contraction is a later performance lever.
``-Xptxas -v`` writes the registers, stack and spills of the kernel into
the build directory's ``build.log``.

The kernel-time probes (``puppax_torch/probes``) build other variants:
K1's body cut after a phase, one-thread or team, in their own launch
shells, or under ``--fmad=true`` (``probe_flags``). A variant is its own
library and its own ``last_build`` record (``record_name``: the shell, the
cut, the flags that differ from ``NVCC_FLAGS``), so a probe build never
stands in for a production one. The production kernels build with ``NVCC_FLAGS`` only.

Each nvcc is one subprocess, so ``build_in_parallel`` builds several
kernels at once from threads. Rendering a body is Python under one lock
(seconds each); ``build_batch`` renders a batch's bodies in a pool of
processes (``render_in_processes``) and starts each nvcc as its body
lands; ``start_batch`` runs such a batch behind the caller, its processes
at the niceness ``nice``.
``check_blocks`` and ``launch`` are the wrappers' shared checks of the
``(rows, B)`` input blocks and their launch on the current stream;
``launch_into`` launches into outputs the caller allocated;
``bind_scratch`` gives a box model's team body its global scratch.
"""

from __future__ import annotations

import ctypes
import hashlib
import multiprocessing
import os
import pickle
import shutil
import subprocess
import threading
import time
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor, as_completed
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_ROOT = REPO_ROOT / "build" / "puppax_torch_kernels"
CSRC = Path(__file__).resolve().parents[1] / "csrc"
COMMON = CSRC / "common.cuh"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# C++20 for the team shells' std::barrier (csrc/team.cuh)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread")


@dataclass(frozen=True)
class Kernel:
    """One generated kernel: its launch shell, its pointer count and the
    names of its C entry points."""

    name: str
    shell: Path
    n_pointers: int
    launch: str  # (pointers..., int B, ints..., void* stream), nvcc build
    host: str  # (pointers..., int B, ints...), g++ build
    n_ints: int = 0  # ints after B
    headers: Tuple[Path, ...] = ()  # headers the shell includes besides common.cuh


WRAPPED_STEP = Kernel("wrapped_step", CSRC / "wrapped_step.cuh", 13,  # 8 in + 5 out
                      "wrapped_step_launch", "wrapped_step_host")
ENV_STEP = Kernel("env_step", CSRC / "env_step.cuh", 10,  # 6 in + 4 out
                  "env_step_launch", "env_step_host")
PHYSICS_STEP = Kernel("physics_step", CSRC / "physics_step.cuh", 7,  # 4 in + 3 out
                      "physics_step_launch", "physics_step_host")
# the team kernels: K3's, K2's and K1's programs split across the warps of a
# block (kernels/team.py); the production K3, K2 and K1 (soa_env.wrapped_step,
# soa_env.env_step, soa.step_batched)
WRAPPED_STEP_TEAM = Kernel("wrapped_step_team", CSRC / "wrapped_step_team.cuh", 13,
                           "wrapped_step_team_launch", "wrapped_step_team_host",
                           headers=(CSRC / "team.cuh",))
ENV_STEP_TEAM = Kernel("env_step_team", CSRC / "env_step_team.cuh", 10, "env_step_team_launch",
                       "env_step_team_host", headers=(CSRC / "team.cuh",))
PHYSICS_STEP_TEAM = Kernel("physics_step_team", CSRC / "physics_step_team.cuh", 7,
                           "physics_step_team_launch", "physics_step_team_host",
                           headers=(CSRC / "team.cuh",))
# 10 in + 10 out + 4 scratch; ints T, n_layers, activation, gait, the 9 layer
# widths: the one-thread K4 (the A/B baseline) and team K4, the production K4
# (env/fused_unroll.py::unroll)
FUSED_UNROLL = Kernel("fused_unroll", CSRC / "fused_unroll.cuh", 24,
                      "fused_unroll_launch", "fused_unroll_host", n_ints=13,
                      headers=(CSRC / "fused_policy.cuh",))
FUSED_UNROLL_TEAM = Kernel("fused_unroll_team", CSRC / "fused_unroll_team.cuh", 24,
                           "fused_unroll_team_launch", "fused_unroll_team_host", n_ints=13,
                           headers=(CSRC / "team.cuh", CSRC / "fused_policy.cuh"))
# warps per block of each team kernel (chosen on the card from the sweeps of
# probes/profile_layout.py and probes/profile_team.py; PERF.md)
TEAM_WARPS = {"wrapped_step_team": 6, "env_step_team": 6, "physics_step_team": 4,
              "fused_unroll_team": 6}
# team K4's MLP outputs per thread at once (K4_R; chosen on the card from the
# sweep of probes/profile_team.py --kernel K4; PERF.md)
K4_MLP_ROWS = 16
# jax's threefry2x32 and the draws from it (puppax_torch/random.py; no
# generated body): keys, lo, hi, out; B = the keys; ints n, offset, mode and
# the keys' row stride
THREEFRY = Kernel("threefry", CSRC / "threefry.cuh", 4, "threefry_launch", "threefry_host",
                  n_ints=4)
# the probes' shells: K1's body in two layouts (4 in + 3 out + the sink row;
# ints threads, layout and the row counts nq, nv, nu, ndr, ncache); the multiply-add
# chain (a, b, out; B = threads per block; ints K, mode, blocks); x + 1
# (x, out; B = elements)
PROBE_PHYSICS = Kernel("probe_physics", CSRC / "probe_physics.cuh", 8,
                       "probe_physics_launch", "probe_physics_host", n_ints=7)
# the team probes' shell: team K1's body (kernels/team.py) cut after a phase,
# with the sink row, in two layouts (the same 8 blocks; ints layout and the
# row counts nq, nv, nu, ndr, ncache)
PROBE_PHYSICS_TEAM = Kernel("probe_physics_team", CSRC / "probe_physics_team.cuh", 8,
                            "probe_physics_team_launch", "probe_physics_team_host", n_ints=6,
                            headers=(CSRC / "team.cuh",))
FMA_CHAIN = Kernel("fma_chain", CSRC / "probe_fma.cuh", 3,
                   "fma_chain_launch", "fma_chain_host", n_ints=3)
# the chain's redesign, the same shell: 8 interleaved elements per thread on
# a grid sized to the resident blocks (a, b, out; B = n; ints K, mode,
# blocks)
FMA_CHAIN_ILP = Kernel("fma_chain_ilp", CSRC / "probe_fma.cuh", 3,
                       "fma_chain_ilp_launch", "fma_chain_ilp_host", n_ints=3)
ADD_ONE = Kernel("add_one", CSRC / "probe_add_one.cuh", 2, "add_one_launch", "add_one_host")
# its redesign, the same shell: float4 on a grid of per_sm blocks on each SM,
# launched with programmatic dependent launch (x, out; B = n; ints threads,
# per_sm, pdl)
ADD_ONE_PDL = Kernel("add_one_pdl", CSRC / "probe_add_one.cuh", 2, "add_one_pdl_launch",
                     "add_one_pdl_host", n_ints=3)
# the overhead probes' copy: q, v, ctrl, dr in; q, v, caches, sink out; ints
# the mode (q, min, full) and the row counts nq, nv, nu, ndr, ncache; its
# one-thread design, the A/B baseline, is the entry probe_copy_one_thread_*
PROBE_COPY = Kernel("probe_copy", CSRC / "probe_copy.cuh", 8,
                    "probe_copy_launch", "probe_copy_host", n_ints=6)
# probe group C: the synthetic SoA substep (q, v in; q out; a generated
# body) and the batched 18 x 18 SPD solve (A, b in; x out)
PROBE_SOA = Kernel("probe_soa", CSRC / "probe_soa.cuh", 3, "probe_soa_launch", "probe_soa_host")
# the SoA substep's program split across the warps of a block (kernels/team.py)
PROBE_SOA_TEAM = Kernel("probe_soa_team", CSRC / "probe_soa_team.cuh", 3,
                        "probe_soa_team_launch", "probe_soa_team_host",
                        headers=(CSRC / "team.cuh",))
PROBE_SPD = Kernel("probe_spd", CSRC / "probe_spd.cuh", 3, "probe_spd_launch", "probe_spd_host")
# its redesign, one warp per env (A, b in; x out; int W, the warps per block)
PROBE_SPD_WARP = Kernel("probe_spd_warp", CSRC / "probe_spd_warp.cuh", 3,
                        "probe_spd_warp_launch", "probe_spd_warp_host", n_ints=1)

# (record name, the statics' content digest, config) -> loaded library
_LOADED: Dict[Tuple, ctypes.CDLL] = {}
# (id(s), id(es)) -> (s, es, their content digest); holding s and es keeps
# their ids unique
_DIGESTS: Dict[Tuple[int, int], Tuple[object, object, str]] = {}
# (the statics' content digest, substeps, episode length, warps, the line
# search's trips) -> team K3's rendered (source, stats): team K3 and team K4
# build the same schedule, rendered once (seconds each); filled only under
# _EMIT_LOCK by the two device libraries below
_TEAM_K3_BODIES: Dict[Tuple, Tuple[str, dict]] = {}
_EMIT_LOCK = threading.Lock()
# (record name, the statics' content digest, config) -> (body, seconds) that
# render_in_processes rendered ahead; taken by the library's first build
_RENDERED: Dict[Tuple, Tuple[object, float]] = {}
# what a library call does instead of building: "render" (in a render
# process) returns its body, "key" returns its _LOADED key
_INSTEAD: Optional[str] = None
# the niceness of the compilers and render processes a build starts (0: as
# this process); a caller that builds while it measures raises it
nice = 0

# what the last build of each kernel did: record_name -> {"compile_seconds":
# ..., "ops_per_env": float operations of one env's run, cgen.op_count,
# "host_cpus": the build host's os.cpu_count(), which the wall time of a
# parallel build depends on}
last_build: Dict[str, Dict[str, object]] = {}


def probe_flags(fmad: bool) -> Tuple[str, ...]:
    """``NVCC_FLAGS``, with multiply-add contraction on if ``fmad`` (a
    probe-only build: the production kernels keep ``--fmad=false``)."""
    return tuple("--fmad=true" if fmad and f == "--fmad=false" else f for f in NVCC_FLAGS)


def record_name(kernel: Kernel, variant: str = "", flags: Sequence[str] = NVCC_FLAGS) -> str:
    """A build's key in ``last_build``: the kernel's name (its shell), then
    the variant (a probe's phase cut) and the flags that differ from
    ``NVCC_FLAGS``, each in brackets; a production build is its name alone."""
    extra = " ".join(f for f in flags if f not in NVCC_FLAGS)
    return kernel.name + "".join(f"[{t}]" for t in (variant, extra) if t)


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (CUDA toolkit required to build kernels)")


def compile_library(kernel: Kernel, body: str, compiler: Sequence[str],
                    flags: Sequence[str], out_root: Path,
                    lib_name: str) -> Tuple[Path, bool, float]:
    """Compile ``kernel``'s shell around ``body`` into
    ``<out_root>/<hash>/lib_name``. Returns (library path, whether it was
    cached, seconds spent)."""
    headers = {h.name: h.read_text() for h in (kernel.shell, COMMON, *kernel.headers)}
    # the unit names the kernel: two kernels of one shell never share a directory
    unit_text = (f'#define PUPPAX_KERNEL_BODY "{kernel.name}_body.inc"\n'
                 f'#include "{kernel.shell.name}"\n')
    digest = hashlib.sha256(
        "\0".join([body, unit_text, *headers.values(), " ".join(compiler),
                    " ".join(flags)]).encode()
    ).hexdigest()
    d = Path(out_root) / digest
    lib = d / lib_name
    if lib.exists():
        return lib, True, 0.0
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{kernel.name}_body.inc").write_text(body)
    for name, text in headers.items():
        (d / name).write_text(text)
    unit = d / f"{kernel.name}_unit.cu"
    unit.write_text(unit_text)
    tmp = d / f".{lib_name}.{os.getpid()}.tmp"
    cmd = (["nice", "-n", str(nice)] if nice else []) + [*compiler, *flags, "-I", str(d), "-o",
                                                         str(tmp), str(unit)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    (d / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr + f"\n{secs:.1f} s\n"
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"{kernel.name} build failed ({proc.returncode}): {' '.join(cmd)}\n"
            + (proc.stdout + proc.stderr)[-4000:]
        )
    os.replace(tmp, lib)
    return lib, False, secs


def _bind(lib: ctypes.CDLL, kernel: Kernel, with_stream: bool, entry: Optional[str] = None):
    """Set the argument types of ``kernel``'s launch (or host) entry, or of
    another ``entry`` of its shell with the same arguments; returns it."""
    fn = getattr(lib, entry or (kernel.launch if with_stream else kernel.host))
    args = [ctypes.c_void_p] * kernel.n_pointers + [ctypes.c_int] * (1 + kernel.n_ints)
    if with_stream:
        args.append(ctypes.c_void_p)
    fn.argtypes = args
    fn.restype = ctypes.c_int
    return fn


def _device_library(kernel: Kernel, s, es, config: Tuple[int, ...],
                    make_body: Callable[[], object], variant: str = "",
                    flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    """``make_body`` returns the generated source, or (source, stats) for a
    team body (``team.render``: its stats go into the build record)."""
    name = record_name(kernel, variant, flags)
    key = (name, _statics_digest(s, es), config)
    if _INSTEAD == "key":
        return key
    if _INSTEAD == "render":
        return make_body()
    hit = _LOADED.get(key)
    if hit is not None:
        return hit
    body, gen_secs = _RENDERED.pop(key, (None, 0.0))
    if body is None:
        with _EMIT_LOCK:  # the value algebra's CSE memo is process-global
            t0 = time.perf_counter()
            body = make_body()
            gen_secs = time.perf_counter() - t0
    body, stats = body if isinstance(body, tuple) else (body, {})
    path, cached, secs = compile_library(
        kernel, body, [nvcc_path()], flags, BUILD_ROOT, f"lib{kernel.name}.so"
    )
    lib = ctypes.CDLL(str(path))
    _bind(lib, kernel, with_stream=True)
    from puppax_torch.kernels import cgen

    last_build[name] = dict(
        generate_seconds=gen_secs, compile_seconds=secs, cached=cached,
        dir=str(path.parent), lines=body.count("\n"), host_cpus=os.cpu_count(),
        **({"ops_per_env": cgen.op_count(body)} if not stats else stats),
    )
    _LOADED[key] = lib
    return lib


def _statics_digest(s, es) -> str:
    """sha256 of the model and env statics' contents (plain Python values),
    computed once per pair of objects: envs built alike in one process, such
    as the training CLI's and a caller's, share their kernels without
    rendering the bodies again (seconds each)."""
    k = (id(s), id(es))
    hit = _DIGESTS.get(k)
    if hit is None:
        contents = pickle.dumps([None if x is None else vars(x) for x in (s, es)])
        hit = _DIGESTS[k] = (s, es, hashlib.sha256(contents).hexdigest())
    return hit[2]


def model_variant(s) -> str:
    """The model's part of a build's record name: ``boxes`` for a model
    with sphere-box pairs (obstacle terrain), ``hfield`` for one with
    hfield-sphere pairs (heightfield terrain), ``capsule`` for one with
    capsule pairs (a capsule-legged MJCF), each that applies, none for the
    flat model (so another model's body builds beside the flat one and
    never overwrites its record)."""
    kinds = {p.kind for p in s.pairs}
    return _variant("boxes" if "bs" in kinds else "", "hfield" if "hs" in kinds else "",
                    "capsule" if kinds & {"pc", "sc", "cc"} else "")


def env_variant(es, privileged: bool = True) -> str:
    """The env configuration's part of a K2, K3 or K4 build's record name:
    none at the default observation history of 2 without privileged rows,
    else e.g. ``history 4, privileged`` (so such a build never overwrites
    the default one's record). K2 passes ``privileged=False``: its body
    stores no privileged rows."""
    history = es.hist // es.obs_dim
    parts = [f"history {history}"] if history != 2 else []
    return ", ".join(parts + (["privileged"] if privileged and es.priv else []))


def _variant(*parts: str) -> str:
    return " ".join(p for p in parts if p)


def wrapped_step_library(s, es, n_substeps: int, episode_length: int) -> ctypes.CDLL:
    """The one-thread wrapped-step kernel (K3, the A/B baseline of team K3)
    for this configuration, built with nvcc for sm_90a at first use and
    cached for the process."""
    from puppax_torch.kernels import cgen

    return _device_library(
        WRAPPED_STEP, s, es, (int(n_substeps), int(episode_length)),
        lambda: cgen.wrapped_step_body(s, es, n_substeps, episode_length),
        variant=_variant(model_variant(s), env_variant(es)),
    )


def env_step_library(s, es, n_substeps: int) -> ctypes.CDLL:
    """The unwrapped env-step kernel (K2) for this configuration, built with
    nvcc for sm_90a at first use and cached for the process."""
    from puppax_torch.kernels import cgen

    return _device_library(
        ENV_STEP, s, es, (int(n_substeps),),
        lambda: cgen.env_step_body(s, es, n_substeps),
        variant=_variant(model_variant(s), env_variant(es, privileged=False)),
    )


def physics_step_library(s, n_substeps: int) -> ctypes.CDLL:
    """The physics-step kernel (K1) for this model and substep count, built
    with nvcc for sm_90a at first use and cached for the process."""
    from puppax_torch.kernels import cgen

    return _device_library(
        PHYSICS_STEP, s, None, (int(n_substeps),),
        lambda: cgen.physics_step_body(s, n_substeps),
        variant=model_variant(s),
    )


def team_variant(kernel: Kernel, warps: int) -> str:
    """The variant of a team build: none at ``TEAM_WARPS``, else its warps
    (a sweep's build is its own record, ``record_name(kernel, variant)``)."""
    return "" if warps == TEAM_WARPS[kernel.name] else f"{warps} warps"


def _team_k3_body(s, es, n_substeps: int, episode_length: int, warps: int):
    """Team K3's (source, stats) for this configuration, rendered once in a
    process (``_TEAM_K3_BODIES``); called under ``_EMIT_LOCK``."""
    from puppax_torch.kernels import team
    from puppax_torch.physics import soa

    key = (_statics_digest(s, es), int(n_substeps), int(episode_length), int(warps),
           soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS)
    hit = _TEAM_K3_BODIES.get(key)
    if hit is None:
        hit = _TEAM_K3_BODIES[key] = team.wrapped_step_team_body(s, es, n_substeps,
                                                                 episode_length, warps)
    return hit[0], dict(hit[1])


def wrapped_step_team_library(s, es, n_substeps: int, episode_length: int,
                              warps: Optional[int] = None) -> ctypes.CDLL:
    """Team K3 (``kernels/team.py`` around K3's program, ``warps`` warps per
    block, ``TEAM_WARPS`` by default), built with nvcc for sm_90a at first
    use and cached for the process. Its build record's ``ops_per_env`` is
    the one-thread program's count, so a bound reads the same work."""
    warps = warps or TEAM_WARPS[WRAPPED_STEP_TEAM.name]
    return _device_library(
        WRAPPED_STEP_TEAM, s, es, (int(n_substeps), int(episode_length), warps),
        lambda: _team_k3_body(s, es, n_substeps, episode_length, warps),
        variant=_variant(model_variant(s), env_variant(es),
                         team_variant(WRAPPED_STEP_TEAM, warps)),
    )


def env_step_team_library(s, es, n_substeps: int, warps: Optional[int] = None) -> ctypes.CDLL:
    """Team K2 (``kernels/team.py`` around K2's program, ``warps`` warps per
    block, ``TEAM_WARPS`` by default), built with nvcc for sm_90a at first
    use and cached for the process."""
    from puppax_torch.kernels import team

    warps = warps or TEAM_WARPS[ENV_STEP_TEAM.name]
    return _device_library(
        ENV_STEP_TEAM, s, es, (int(n_substeps), warps),
        lambda: team.env_step_team_body(s, es, n_substeps, warps),
        variant=_variant(model_variant(s), env_variant(es, privileged=False),
                         team_variant(ENV_STEP_TEAM, warps)),
    )


def physics_step_team_library(s, n_substeps: int, warps: Optional[int] = None) -> ctypes.CDLL:
    """Team K1 (``kernels/team.py`` around K1's program, ``warps`` warps per
    block, ``TEAM_WARPS`` by default), built with nvcc for sm_90a at first
    use and cached for the process."""
    from puppax_torch.kernels import team

    warps = warps or TEAM_WARPS[PHYSICS_STEP_TEAM.name]
    return _device_library(
        PHYSICS_STEP_TEAM, s, None, (int(n_substeps), warps),
        lambda: team.physics_step_team_body(s, n_substeps, warps),
        variant=_variant(model_variant(s), team_variant(PHYSICS_STEP_TEAM, warps)),
    )


def fused_unroll_library(s, es, n_substeps: int, episode_length: int) -> ctypes.CDLL:
    """The one-thread fused unroll (K4, the A/B baseline of team K4) for
    this configuration (K3's body inside
    ``csrc/fused_unroll.cuh``), built with nvcc for sm_90a at first use and
    cached for the process."""
    from puppax_torch.kernels import cgen

    return _device_library(
        FUSED_UNROLL, s, es, (int(n_substeps), int(episode_length)),
        lambda: cgen.fused_unroll_body(s, es, n_substeps, episode_length),
        variant=_variant(model_variant(s), env_variant(es)),
    )


def fused_unroll_team_library(s, es, n_substeps: int, episode_length: int,
                              warps: Optional[int] = None, mlp_rows: Optional[int] = None,
                              mlp_only: bool = False) -> ctypes.CDLL:
    """Team K4 (``csrc/fused_unroll_team.cuh`` around K3's program split
    across ``warps`` warps, ``TEAM_WARPS`` by default, and ``mlp_rows`` MLP
    outputs per thread, ``K4_MLP_ROWS`` by default), built with nvcc for
    sm_90a at first use and cached for the process. ``mlp_only`` builds the
    probe variant without the env step (``cgen.fused_unroll_team_body``)."""
    from puppax_torch.kernels import cgen

    warps = warps or TEAM_WARPS[FUSED_UNROLL_TEAM.name]
    mlp_rows = mlp_rows or K4_MLP_ROWS
    variant = _variant(model_variant(s), env_variant(es), team_variant(FUSED_UNROLL_TEAM, warps),
                       "" if mlp_rows == K4_MLP_ROWS else f"R={mlp_rows}",
                       "MLP only" if mlp_only else "")
    return _device_library(
        FUSED_UNROLL_TEAM, s, es,
        (int(n_substeps), int(episode_length), warps, mlp_rows, bool(mlp_only)),
        lambda: cgen.fused_unroll_team_body(
            s, es, n_substeps, episode_length, warps, mlp_rows, mlp_only,
            None if mlp_only else _team_k3_body(s, es, n_substeps, episode_length, warps)),
        variant=variant,
    )


def probe_physics_library(s, n_substeps: int, phase_limit: Optional[str] = None,
                          fmad: bool = False) -> ctypes.CDLL:
    """K1's body, cut after ``phase_limit`` (None: the whole body) and with
    its sink row, in the probes' launch shell ``csrc/probe_physics.cuh``
    (row-major and block-major layouts, 32-128 threads per block), with
    multiply-add contraction if ``fmad``: a probe-only build, recorded as
    ``probe_physics[<cut or full>]`` (plus ``[--fmad=true]``)."""
    from puppax_torch.kernels import cgen

    return _device_library(
        PROBE_PHYSICS, s, None, (int(n_substeps),),
        lambda: cgen.physics_step_body(s, n_substeps, phase_limit, sink=True),
        variant=phase_limit or "full", flags=probe_flags(fmad),
    )


def probe_physics_team_library(s, n_substeps: int, phase_limit: Optional[str] = None,
                               fmad: bool = False, warps: Optional[int] = None,
                               loop_weight: Optional[int] = None,
                               cap: Optional[int] = None) -> ctypes.CDLL:
    """Team K1's program (``team.physics_step_team_body`` at ``warps`` warps,
    ``TEAM_WARPS["physics_step_team"]`` by default, production's schedule
    unless ``loop_weight`` or ``cap`` is given), cut after ``phase_limit``
    (None: the whole program) and with its sink row, in the team probes'
    shell ``csrc/probe_physics_team.cuh`` (row-major and block-major
    layouts), with multiply-add contraction if ``fmad``: a probe-only build,
    recorded as ``probe_physics_team[<cut or full>]`` (plus each knob that
    differs from production's, ``team_probe_variant``, and
    ``[--fmad=true]``). Its ``ops_per_env`` is the one-thread cut's
    (``probe_physics[<cut or full>]``): the same program."""
    from puppax_torch.kernels import team

    warps = warps or TEAM_WARPS[PHYSICS_STEP_TEAM.name]
    loop_weight = team.REPLICATED_LOOP_WEIGHT if loop_weight is None else int(loop_weight)
    cap = cap or team.CAP
    return _device_library(
        PROBE_PHYSICS_TEAM, s, None, (int(n_substeps), warps, loop_weight, cap),
        lambda: team.physics_step_team_body(s, n_substeps, warps, phase_limit, sink=True,
                                            loop_weight=loop_weight, cap=cap),
        variant=team_probe_variant(phase_limit, warps, loop_weight, cap), flags=probe_flags(fmad),
    )


def team_probe_variant(phase_limit: Optional[str] = None, warps: Optional[int] = None,
                       loop_weight: Optional[int] = None, cap: Optional[int] = None) -> str:
    """The variant of a team probe build: its cut (``full`` for none), then
    each knob that differs from production's (``4 warps``, ``loop weight
    0``, ``cap 16``)."""
    from puppax_torch.kernels import team

    knobs = ((warps, TEAM_WARPS[PHYSICS_STEP_TEAM.name], "{} warps"),
             (loop_weight, team.REPLICATED_LOOP_WEIGHT, "loop weight {}"),
             (cap, team.CAP, "cap {}"))
    return " ".join([phase_limit or "full"] + [fmt.format(v) for v, default, fmt in knobs
                                               if v is not None and v != default])


def wrapped_step_fmad_library(s, es, n_substeps: int, episode_length: int) -> ctypes.CDLL:
    """K3 (``wrapped_step_library``'s source) with multiply-add contraction:
    a probe-only build, recorded as ``wrapped_step[--fmad=true]``."""
    from puppax_torch.kernels import cgen

    return _device_library(
        WRAPPED_STEP, s, es, (int(n_substeps), int(episode_length)),
        lambda: cgen.wrapped_step_body(s, es, n_substeps, episode_length),
        flags=probe_flags(True),
    )


def fma_chain_library(fmad: bool) -> ctypes.CDLL:
    """The multiply-add chain probe's one-element-per-thread design
    (``csrc/probe_fma.cuh``; no generated body), with or without
    multiply-add contraction: recorded as ``fma_chain`` (plus
    ``[--fmad=true]``)."""
    return _device_library(FMA_CHAIN, None, None, (), lambda: "", flags=probe_flags(fmad))


def fma_chain_ilp_library(fmad: bool) -> ctypes.CDLL:
    """The chain's redesign (``csrc/probe_fma.cuh``'s ``fma_chain_ilp_launch``:
    8 interleaved elements per thread, a grid of the resident blocks), with
    or without multiply-add contraction: recorded as ``fma_chain_ilp``
    (plus ``[--fmad=true]``). The entries ``fma_chain_occupancy`` and
    ``fma_chain_ilp_grid`` report the resident blocks and the grid."""
    lib = _device_library(FMA_CHAIN_ILP, None, None, (), lambda: "", flags=probe_flags(fmad))
    if _INSTEAD is None and lib.fma_chain_ilp_grid.argtypes is None:  # a library, bound once
        for fn in (lib.fma_chain_occupancy, lib.fma_chain_ilp_grid):
            fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    return lib


def threefry_library() -> ctypes.CDLL:
    """The threefry kernel (``csrc/threefry.cuh``'s ``threefry_launch``),
    which ``random.threefry`` launches for every draw on the card; the
    entry ``pow_check_launch`` (x, y, out, n, stream: ``powf`` elementwise,
    the emitter's text for a solimp power) is bound beside it."""
    lib = _device_library(THREEFRY, None, None, (), lambda: "")
    if _INSTEAD is None and lib.pow_check_launch.argtypes is None:  # a library, bound once
        lib.pow_check_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.pow_check_launch.restype = ctypes.c_int
    return lib


def add_one_library() -> ctypes.CDLL:
    """The launch-overhead probe's one-element ``x + 1`` kernel
    (``csrc/probe_add_one.cuh``'s ``add_one_launch``), the A/B baseline."""
    return _device_library(ADD_ONE, None, None, (), lambda: "")


def add_one_pdl_library() -> ctypes.CDLL:
    """``x + 1``'s redesign (``csrc/probe_add_one.cuh``'s
    ``add_one_pdl_launch``: float4 on a grid sized to the card, launched
    with programmatic dependent launch), recorded as ``add_one_pdl``. The
    entries ``add_one_pdl_grid`` (the grid of a threads / per-SM choice),
    ``add_one_capture_edges`` (the edges of the graph being captured on a
    stream) and ``add_one_versions`` (toolkit, runtime and CUDA driver) are
    bound beside it."""
    lib = _device_library(ADD_ONE_PDL, None, None, (), lambda: "")
    if _INSTEAD is None and lib.add_one_capture_edges.argtypes is None:  # a library, bound once
        lib.add_one_pdl_grid.argtypes = [ctypes.c_int] * 2
        lib.add_one_pdl_grid.restype = ctypes.c_int
        lib.add_one_capture_edges.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.add_one_capture_edges.restype = ctypes.c_int
        lib.add_one_versions.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.add_one_versions.restype = ctypes.c_int
    return lib


def probe_copy_library() -> ctypes.CDLL:
    """The overhead probes' copy kernel (``csrc/probe_copy.cuh``; no
    generated body): a probe-only build, recorded as ``probe_copy``."""
    return _device_library(PROBE_COPY, None, None, (), lambda: "")


def probe_soa_library(rounds: int, make_body: Callable[[], str]) -> ctypes.CDLL:
    """The synthetic SoA substep (``csrc/probe_soa.cuh`` around the body
    that ``make_body`` returns, the caller's emission of ``rounds`` rounds):
    a probe-only build, recorded as ``probe_soa[<rounds> rounds]``."""
    return _device_library(PROBE_SOA, None, None, (int(rounds),), make_body,
                           variant=f"{int(rounds)} rounds")


def probe_soa_team_library(rounds: int, warps: int, variant: str,
                           make_body: Callable[[], Tuple[str, dict]]) -> ctypes.CDLL:
    """The synthetic SoA substep split across ``warps`` warps
    (``csrc/probe_soa_team.cuh`` around the team body and stats that
    ``make_body`` returns, the caller's schedule of ``rounds`` rounds): a
    probe-only build, recorded as ``probe_soa_team[<variant>]``. Its
    ``ops_per_env`` is the one-thread body's (``probe_soa[<rounds>
    rounds]``): the same program."""
    return _device_library(PROBE_SOA_TEAM, None, None, (int(rounds), int(warps)), make_body,
                           variant=variant)


def probe_spd_library() -> ctypes.CDLL:
    """The batched 18 x 18 SPD solve (``csrc/probe_spd.cuh``; no generated
    body): a probe-only build, recorded as ``probe_spd``."""
    return _device_library(PROBE_SPD, None, None, (), lambda: "")


def probe_spd_warp_library() -> ctypes.CDLL:
    """The batched 18 x 18 SPD solve, one warp per env
    (``csrc/probe_spd_warp.cuh``; no generated body; one build serves every
    W): a probe-only build, recorded as ``probe_spd_warp``."""
    return _device_library(PROBE_SPD_WARP, None, None, (), lambda: "")


def _instead(mode: str, call):
    global _INSTEAD
    _INSTEAD = mode
    try:
        fn, args = call
        return fn(*args)
    finally:
        _INSTEAD = None


def _render(call):
    """A render process's job: the body of one library call, unbuilt."""
    t0 = time.perf_counter()
    body = _instead("render", call)
    return body, time.perf_counter() - t0


def render_in_processes(*calls: Tuple[Callable, tuple], workers: Optional[int] = None,
                        then: Optional[Callable[[int], None]] = None,
                        keys: Optional[list] = None) -> None:
    """Render the bodies of the library calls ``(library function, args)``
    (e.g. ``(wrapped_step_team_library, (s, es, 5, 1000))``) in a pool of
    ``workers`` processes (the host's CPUs by default), so that a parallel
    build of them does not render them one after another under
    ``_EMIT_LOCK``; each build then takes its body (``_RENDERED``) and
    records the render's seconds as its ``generate_seconds``. As each body
    lands, ``then(i)`` is called with its call's index. The processes are
    spawned (a forked child of a process that holds a CUDA context may not
    use it) and each renders the same text as this process would. ``keys``
    are the calls' build keys when the caller took them already
    (``start_batch``)."""
    if keys is None:
        keys = [_instead("key", call) for call in calls]  # before any build reads _INSTEAD
    ctx = multiprocessing.get_context("spawn")
    n = workers or min(len(calls), os.cpu_count() or 1)
    niced = dict(initializer=os.nice, initargs=(nice,)) if nice else {}
    with ProcessPoolExecutor(max_workers=n, mp_context=ctx, **niced) as pool:
        futures = {pool.submit(_render, call): i for i, call in enumerate(calls)}
        for future in as_completed(futures):
            i = futures[future]
            _RENDERED[keys[i]] = future.result()
            if then is not None:
                then(i)


def build_batch(*calls: Tuple[Callable, tuple], keys: Optional[list] = None) -> list:
    """Build the library calls ``(library function, args)`` at once: their
    bodies rendered in a pool of processes (``render_in_processes``), each
    nvcc started in a thread as soon as its body is ready. Returns the
    libraries in the calls' order."""
    with ThreadPoolExecutor(max_workers=len(calls)) as threads:
        builds = [None] * len(calls)

        def start(i):
            fn, args = calls[i]
            builds[i] = threads.submit(fn, *args)

        render_in_processes(*calls, then=start, keys=keys)
        return [b.result() for b in builds]


def start_batch(*calls: Tuple[Callable, tuple], after: Optional[Future] = None) -> Future:
    """``build_batch`` of the calls in a background thread, so the caller
    goes on (with the card) while they render and compile; the returned
    future's result is the libraries. With ``after`` (another batch's
    future) the builds start once that batch is done, so the two do not
    share the host's CPUs. The calls' keys are taken here, in the caller's
    thread: a key lookup sets ``_INSTEAD``, which a library call of the
    caller's must not meet. The caller looks up none of these libraries
    before the future is done. With ``nice`` above 0 the render processes
    and compilers run at that niceness, so a caller measuring on the card
    keeps its CPU."""
    keys = [_instead("key", call) for call in calls]

    def run():
        if after is not None:
            after.result()
        return build_batch(*calls, keys=keys)

    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def build_in_parallel(*builds: Callable[[], object]) -> list:
    """Run the given library builds (e.g. ``lambda: env_step_library(...)``)
    in threads, so their nvcc processes run at the same time."""
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        return [f.result() for f in [pool.submit(b) for b in builds]]


def host_library(kernel: Kernel, body: str, out_root: Path,
                 compiler: str = "g++") -> ctypes.CDLL:
    """The same generated source built for the CPU (the shell's host loop)."""
    path, _, _ = compile_library(kernel, body, [compiler], GXX_FLAGS, out_root,
                                 f"lib{kernel.name}_host.so")
    lib = ctypes.CDLL(str(path))
    _bind(lib, kernel, with_stream=False)
    return lib


# id(library) -> the scratch its team body's indexed arrays live in
_SCRATCH: Dict[int, torch.Tensor] = {}
# the scratches a larger one replaced: kept for the process, never freed
_RETIRED_SCRATCH: list = []


def bind_scratch(lib: ctypes.CDLL, kernel: Kernel, B: int, dev: torch.device) -> None:
    """Give a team library whose body keeps indexed arrays in a global
    scratch (a box model's: ``TEAM_SCRATCH_ROWS`` rows per env,
    ``csrc/team.cuh``) its scratch for ``B`` envs, before each launch. A
    no-op for a body without arrays (0 rows) and for a shell without a
    scratch (no ``<kernel>_scratch_rows`` entry).

    The rule: a library's scratch is allocated at the first launch that
    needs more than the one it has (one library serves several B in a
    process: the physics-only lane's 4096 training envs and 128 evaluation
    envs), and a scratch once passed to a launch is never freed. A CUDA
    graph captured at a smaller B keeps the pointer it was launched with;
    the scratch a larger one replaced stays allocated for the process
    (``_RETIRED_SCRATCH``), so such a graph still replays into live memory,
    which no later launch of the library touches."""
    rows_of = getattr(lib, f"{kernel.name}_scratch_rows", None)
    rows = 0 if rows_of is None else rows_of()
    if rows == 0:
        return
    need = rows * ((B + 31) // 32) * 32
    t = _SCRATCH.get(id(lib))
    if t is None or t.numel() < need or t.device != dev:
        if t is not None:
            _RETIRED_SCRATCH.append(t)
        t = _SCRATCH[id(lib)] = torch.empty(need, dtype=torch.float32, device=dev)
        getattr(lib, f"{kernel.name}_set_scratch")(ctypes.c_void_p(t.data_ptr()))


def check_blocks(in_rows: Sequence[int], blocks) -> Tuple[int, torch.device]:
    """Check a kernel's input blocks: ``len(in_rows)`` contiguous float32
    ``(rows, B)`` tensors on one device. Returns (B, device)."""
    if len(blocks) != len(in_rows):
        raise ValueError(f"expected {len(in_rows)} input blocks, got {len(blocks)}")
    B = blocks[0].shape[-1]
    dev = blocks[0].device
    for i, (x, n) in enumerate(zip(blocks, in_rows)):
        if x.dtype != torch.float32:
            raise TypeError(f"input block {i}: dtype {x.dtype}, expected float32")
        if x.ndim != 2 or x.shape != (n, B):
            raise ValueError(f"input block {i}: shape {tuple(x.shape)}, expected ({n}, {B})")
        if not x.is_contiguous():
            raise ValueError(f"input block {i} is not contiguous")
        if x.device != dev:
            raise ValueError(f"input block {i} on {x.device}, block 0 on {dev}")
    return B, dev


def launch(name: str, lib_fn, blocks, out_rows: Sequence[int], B: int, dev):
    """Allocate the output blocks and launch one kernel on the current
    stream; raise on a launch error."""
    outs = [torch.empty((n, B), dtype=torch.float32, device=dev) for n in out_rows]
    launch_into(name, lib_fn, list(blocks) + outs, B)
    return tuple(outs)


def launch_into(name: str, lib_fn, tensors, B: int, *ints: int):
    """Launch one kernel on the current stream of the tensors' device (the
    capture stream inside ``torch.cuda.graph``) with the tensors' pointers
    (inputs, then outputs the caller allocated; None passes a null pointer,
    for an operand the kernel does not touch), ``B`` and ``ints``; raise on
    a launch error."""
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = lib_fn(*[None if t is None else t.data_ptr() for t in tensors], B, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
