"""Shared parts of the kernel-time probes.

- ``require_cuda`` and ``nvidia_smi``: a probe's command line runs on
  ``cuda:0`` and prints the card's name and power limit beside its numbers.
- ``eager_and_graph_ms`` and ``carried_us``: a window of launches timed
  with CUDA events (best of several windows), the state carried between
  two preallocated buffer sets, eagerly and replayed from one captured
  CUDA graph (``capture_graph``); ``host_us``: the host's time to issue
  one call.
- ``launches`` / ``count_launch``: the probe kernels' launch counts by
  name, graph replays included.
- ``physics_probe``: the wrapper of K1's probe builds
  (``csrc/probe_physics.cuh``: q, v, caches and the sink row out), and
  the block layouts it takes (``to_block_major`` / ``from_block_major``);
  ``physics_probe_team``: the same for team K1's probe builds
  (``csrc/probe_physics_team.cuh``, 32-env tiles).
- ``copy_probe``: the wrapper of the overhead probes' copy kernel
  (``csrc/probe_copy.cuh``, three operand sets; element-parallel), its
  plain version ``copy_rows`` and ``check_copy``, one launch held against
  it; ``copy_probe_one_thread``: the same file's one-thread copy, the A/B
  baseline.
- ``sass_counts``: the FFMA / FMUL / FADD instructions of a build
  (``fp32_counts`` of one kernel function); ``mnemonic_counts``: any
  mnemonics' counts; ``sass_loops``: the
  instruction mix of each loop of a kernel function; ``ptxas_info``: a
  build's registers, stack and spill bytes.
- ``clock_under_load``: ``nvidia-smi``'s SM clock sampled while a window
  of launches runs back to back.
- ``nominal_setup`` / ``nominal_blocks``: the TPU probes' inputs.
- ``compare_exact``: the bit-for-bit comparison of a probe with its plain
  version.
"""

from __future__ import annotations

import collections
import math
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from puppax_torch.kernels import build
from puppax_torch.physics import soa

ROW_MAJOR, BLOCK_MAJOR = 0, 1
LAYOUT_NAMES = {ROW_MAJOR: "row-major", BLOCK_MAJOR: "block-major"}
TILE = 128  # envs per tile of the block-major layout (csrc/probe_physics.cuh)
TEAM_TILE = 32  # envs per tile, and per block, of the team probes (csrc/probe_physics_team.cuh)
ITERS = 50  # launches per timed window, as the TPU probes' 50-step scans
RUNS = 3  # timed windows; the best one counts


def require_cuda(prog: str):
    """Exit, printing no result, unless a CUDA device is visible."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device found (torch.cuda.is_available() is False)")


def nvidia_smi(query: str = "name,power.limit", units: bool = True) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def window_ms(fn: Callable[[], object]) -> float:
    """Milliseconds of one call of ``fn`` (a window of launches) on the
    card, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def best_ms(window: Callable[[], object], runs: int = RUNS,
            setup: Optional[Callable[[], object]] = None) -> float:
    """The best of ``runs`` timed windows, each after ``setup()`` (outside
    the window)."""
    best = math.inf
    for _ in range(runs):
        if setup is not None:
            setup()
        best = min(best, window_ms(window))
    return best


def host_us(call: Callable[[], object], iters: int = ITERS, runs: int = RUNS) -> float:
    """Microseconds of host time per ``call()`` (one launch, issued without
    waiting for the card): the best of ``runs`` windows of ``iters`` calls
    on the host clock, the card synchronized before and after each window
    (outside it)."""
    best = math.inf
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best * 1e6 / iters


# kernel name -> launches of the probes' kernels, graph replays included;
# each probe wrapper counts through count_launch where it launches
launches = collections.Counter()
_captured = collections.Counter()  # launches recorded into the graph being captured


def count_launch(name: str):
    """Add one launch of kernel ``name``. Inside a graph capture the kernel
    is only recorded: ``eager_and_graph_ms`` counts it once per replay."""
    if torch.cuda.is_current_stream_capturing():
        _captured[name] += 1
    else:
        launches[name] += 1


def capture_graph(window: Callable[[], object]) -> Tuple[torch.cuda.CUDAGraph, dict]:
    """``window`` captured once as a CUDA graph (on the capture stream,
    which ``build.launch_into`` launches on). Returns the graph and the
    launches recorded into it by kernel name, which each replay adds to
    ``launches``."""
    _captured.clear()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        window()
    return graph, dict(_captured)


def eager_and_graph_ms(window: Callable[[], object], runs: int = RUNS,
                       setup: Optional[Callable[[], object]] = None) -> Tuple[float, float]:
    """(eager ms, graph ms) of one window of launches: the best of ``runs``
    eager windows, and the best of ``runs`` replays of the window captured
    once as a CUDA graph (captured on the capture stream, which
    ``build.launch_into`` launches on). A graph replays its kernels back to
    back without the host's launch work in between, as the TPU probes'
    one-dispatch scans do, so its time is the device's; the eager time adds
    the host's launch work where that is the longer."""
    eager = best_ms(window, runs, setup)
    if setup is not None:
        setup()
    graph, per_replay = capture_graph(window)
    best = math.inf
    for _ in range(runs):
        if setup is not None:
            setup()
        best = min(best, window_ms(graph.replay))
        launches.update(per_replay)
    return eager, best


class Carry:
    """Two preallocated (x, ...) buffer sets for ``iters`` back-to-back
    steps with the state carried: step i reads one set and writes the
    other, so nothing is allocated between launches. ``reset()`` puts the
    initial state back (outside a timed window); ``window()`` runs the
    steps, each ``step(*inputs, *outputs)``."""

    def __init__(self, step: Callable, state: Sequence[torch.Tensor], iters: int):
        self.step, self.state, self.iters = step, list(state), iters
        self.sets = [[x.clone() for x in state], [torch.empty_like(x) for x in state]]

    def reset(self):
        for buf, x in zip(self.sets[0], self.state):
            buf.copy_(x)

    def window(self):
        for i in range(self.iters):
            self.step(*self.sets[i % 2], *self.sets[(i + 1) % 2])


def carried_us(step: Callable, state: Sequence[torch.Tensor], iters: int = ITERS,
               runs: int = RUNS) -> Tuple[float, float]:
    """(eager, graph) microseconds per step of ``iters`` back-to-back
    ``step`` calls with the state carried (``Carry``), by
    ``eager_and_graph_ms``; the graph's is the device's time."""
    c = Carry(step, state, iters)
    eager, graph = eager_and_graph_ms(c.window, runs, c.reset)
    return eager * 1e3 / iters, graph * 1e3 / iters


def sass_of(lib) -> Optional[str]:
    """``cuobjdump -sass`` of a library (None where the toolkit has no
    cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=600, check=True).stdout


def sass_text(record: str, kernel: build.Kernel) -> Optional[str]:
    """``sass_of`` a build's library."""
    return sass_of(os.path.join(build.last_build[record]["dir"], f"lib{kernel.name}.so"))


FP32_OPS = ("FFMA", "FMUL", "FADD")
_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
                         r"(?:\.\S*)?\s*(.*?)\s*;")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")
_SASS_REG = re.compile(r"^[-|!]*R(\d+)(\.reuse)?")


def _operand_reads(body) -> dict:
    """The FP32 instructions of a loop body by how they read their source
    registers: ``three_register`` (three sources in registers, not RZ),
    ``reused`` (sources served by the operand reuse cache: the previous
    instruction flagged the same register ``.reuse`` in the same slot) and
    ``bank_conflicts`` (two sources read from the register file in one of
    the two banks, by register number mod 2; a guess at Hopper's banks from
    published microbenchmarks of Volta and Turing)."""
    out = dict(three_register=0, reused=0, bank_conflicts=0)
    prev = []
    for _, op, args in body:
        srcs = []
        for a in [x.strip() for x in args.split(",")][1:]:
            m = _SASS_REG.match(a)
            srcs.append((int(m.group(1)), bool(m.group(2))) if m else None)
        if op in FP32_OPS:
            regs = [s for s in srcs if s is not None]
            out["three_register"] += len(regs) == 3
            file_reads = []
            for slot, src in enumerate(srcs):
                if src is None:
                    continue
                if slot < len(prev) and prev[slot] is not None and prev[slot] == (src[0], True):
                    out["reused"] += 1
                else:
                    file_reads.append(src[0] % 2)
            out["bank_conflicts"] += len(file_reads) > len(set(file_reads))
        prev = srcs
    return out


def sass_functions(text: str) -> dict:
    """The kernel functions of ``cuobjdump -sass`` text: (mangled) name ->
    its instructions as (address, mnemonic without modifiers, operands)
    and its labels (label -> index of the next instruction)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _SASS_FUNCTION.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), {"instrs": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            cur["labels"][m.group(1)] = len(cur["instrs"])
            continue
        m = _SASS_INSTR.match(line)
        if m:
            cur["instrs"].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def fp32_counts(text: str, function: str = "") -> dict:
    """How many FFMA, FMUL and FADD instructions ``cuobjdump -sass`` text
    holds: in every kernel function, or in those whose mangled name holds
    ``function``."""
    counts = collections.Counter()
    for name, f in sass_functions(text).items():
        if function in name:
            counts.update(op for _, op, _ in f["instrs"] if op in FP32_OPS)
    return {op: counts[op] for op in FP32_OPS}


def mnemonic_counts(text: str, mnemonics: Sequence[str], function: str = "") -> dict:
    """How many instructions of each of ``mnemonics`` (and ``total``, all
    of them) the kernel functions of ``cuobjdump -sass`` text whose mangled
    name holds ``function`` hold."""
    ops = [op for name, f in sass_functions(text).items() if function in name
           for _, op, _ in f["instrs"]]
    return dict({m: ops.count(m) for m in mnemonics}, total=len(ops))


def sass_counts(record: str, kernel: build.Kernel) -> Optional[dict]:
    """``fp32_counts`` of a build's every kernel function (None where the
    toolkit has no cuobjdump)."""
    text = sass_text(record, kernel)
    return None if text is None else fp32_counts(text)


def sass_loops(text: str, function: str = "") -> list:
    """Each loop (a branch back to an earlier instruction) of the kernel
    functions whose mangled name holds ``function``, innermost first within
    a function: ``function``, ``instructions`` of its body, ``fp32`` (its
    FFMA / FMUL / FADD), ``other`` (every other mnemonic of the body, with
    counts: the loop's counter, compare and branch among them), ``reads``
    (``_operand_reads``) and ``inner`` (no other loop lies inside it)."""
    loops = []
    for name, f in sass_functions(text).items():
        if function not in name:
            continue
        instrs, labels = f["instrs"], f["labels"]
        index = {addr: i for i, (addr, _, _) in enumerate(instrs)}
        found = []
        for j, (_, op, args) in enumerate(instrs):
            if op != "BRA":
                continue
            m = _SASS_TARGET.search(args)
            if not m:
                continue
            i = labels.get(m.group(1)) if m.group(1) else index.get(int(m.group(2), 16))
            if i is None or i > j:
                continue
            body = collections.Counter(op for _, op, _ in instrs[i:j + 1])
            found.append(dict(function=name, instructions=j + 1 - i,
                              fp32={op: body[op] for op in FP32_OPS if body[op]},
                              other={op: n for op, n in sorted(body.items())
                                     if op not in FP32_OPS},
                              reads=_operand_reads(instrs[i:j + 1]), span=(i, j)))
        spans = [x.pop("span") for x in found]
        for x, (i, j) in zip(found, spans):
            x["inner"] = not any(i <= a and b <= j and (a, b) != (i, j) for a, b in spans)
        loops += sorted(found, key=lambda x: x["instructions"])
    return loops


def clock_under_load(window: Callable[[], object], seconds: float = 1.0) -> list:
    """``nvidia-smi``'s ``clocks.sm`` (MHz) sampled from a second thread
    while ``window()`` runs back to back on the card for ``seconds``; the
    samples in order."""
    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            samples.append(float(nvidia_smi("clocks.sm", units=False)))

    window()
    torch.cuda.synchronize()
    sampler = threading.Thread(target=sample)
    t0 = time.perf_counter()
    sampler.start()
    try:
        while time.perf_counter() - t0 < seconds or not samples:
            window()
            torch.cuda.synchronize()
    finally:
        done.set()
        sampler.join()
    return samples


def to_block_major(x: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """A ``(rows, B)`` block as the block-major ``(B / tile, rows, tile)``
    layout (env b in tile b // tile, lane b % tile): ``TILE`` for
    ``csrc/probe_physics.cuh``, ``TEAM_TILE`` for
    ``csrc/probe_physics_team.cuh``."""
    rows, B = x.shape
    if B % tile:
        raise ValueError(f"block-major needs B a multiple of {tile}, got {B}")
    return x.reshape(rows, B // tile, tile).permute(1, 0, 2).contiguous()


def from_block_major(x: torch.Tensor) -> torch.Tensor:
    """A block-major ``(B / tile, rows, tile)`` block back as ``(rows, B)``."""
    tiles, rows, lanes = x.shape
    return x.permute(1, 0, 2).reshape(rows, tiles * lanes)


def k1_probe_name(phase_limit: Optional[str] = None, layout: int = ROW_MAJOR,
                  fmad: bool = False, team: bool = False) -> str:
    """The name of one K1 probe kernel: its design (``team``: team K1's
    program), cut, layout and flags."""
    name = f"k1_{'team_' if team else ''}probe_{phase_limit or 'full'}"
    if layout == BLOCK_MAJOR:
        name += "_block_major"
    return name + ("_fmad" if fmad else "")


def probe_out_rows(s) -> Tuple[int, ...]:
    """Row counts of the probe shell's output blocks: K1's q, v and caches,
    then the sink row."""
    return (*soa.physics_block_rows(s)[1], 1)


def _check_physics_blocks(s, blocks, outs, layout: int, tile: int = TILE,
                          multiple: int = TILE) -> Tuple[int, torch.device]:
    """(B, device) of a probe's blocks in ``layout`` (block-major in
    ``tile``-env tiles); B must be a multiple of ``multiple``."""
    in_rows, out_rows = soa.physics_block_rows(s)[0], probe_out_rows(s)
    if layout not in LAYOUT_NAMES:
        raise ValueError(f"layout {layout!r} is not one of {sorted(LAYOUT_NAMES)}")
    if len(blocks) != len(in_rows) or len(outs) != len(out_rows):
        raise ValueError(f"expected {len(in_rows)} input and {len(out_rows)} output blocks")
    dev = blocks[0].device
    B = blocks[0].shape[-1] if layout == ROW_MAJOR else blocks[0].shape[0] * tile
    if B % multiple:
        raise ValueError(f"the probe shell needs B a multiple of {multiple}, got {B}")
    for i, (x, n) in enumerate(zip(list(blocks) + list(outs), list(in_rows) + list(out_rows))):
        shape = (n, B) if layout == ROW_MAJOR else (B // tile, n, tile)
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"block {i}: {x.dtype} {tuple(x.shape)}, expected contiguous "
                             f"float32 {shape}")
        if x.device != dev:
            raise ValueError(f"block {i} on {x.device}, block 0 on {dev}")
    return B, dev


def physics_probe(s, n_substeps: int, blocks: Sequence[torch.Tensor],
                  outs: Sequence[torch.Tensor], phase_limit: Optional[str] = None,
                  layout: int = ROW_MAJOR, threads: int = 128, fmad: bool = False,
                  name: Optional[str] = None):
    """One physics step of K1's probe build (the body cut after
    ``phase_limit``; ``fmad``: built with multiply-add contraction) into
    the preallocated ``outs`` (q, v, caches, sink), every block in ``layout``.

    CPU tensors run the plain version (``soa.physics_step_rows`` with the
    cut and the sink); CUDA tensors launch the kernel of ``csrc/probe_physics.cuh`` with
    ``threads`` per block on the current stream, or raise. Each launch
    counts in ``launches[name]``, by default ``k1_probe_name(...)``."""
    B, dev = _check_physics_blocks(s, blocks, outs, layout)
    if threads not in (32, 64, 128):
        raise ValueError(f"threads per block {threads} is not 32, 64 or 128")
    if dev.type == "cpu":
        rows = blocks if layout == ROW_MAJOR else [from_block_major(x) for x in blocks]
        want = soa.physics_step_rows(s, n_substeps, *rows, phase_limit=phase_limit, sink=True)
        for o, w in zip(outs, want):
            o.copy_(w if layout == ROW_MAJOR else to_block_major(w))
        return
    if dev.type != "cuda":
        raise ValueError(f"physics_probe: unsupported device {dev}")
    lib = build.probe_physics_library(s, n_substeps, phase_limit, fmad)
    rows = (s.nq, s.nv, s.nu, s.ndr, s.ncache)
    build.launch_into("probe_physics", lib.probe_physics_launch, list(blocks) + list(outs), B,
                      threads, layout, *rows)
    count_launch(name or k1_probe_name(phase_limit, layout, fmad))


def physics_probe_team(s, n_substeps: int, blocks: Sequence[torch.Tensor],
                       outs: Sequence[torch.Tensor], phase_limit: Optional[str] = None,
                       layout: int = ROW_MAJOR, fmad: bool = False, warps: Optional[int] = None,
                       loop_weight: Optional[int] = None, cap: Optional[int] = None,
                       name: Optional[str] = None):
    """``physics_probe`` through team K1's probe build (team K1's program cut
    after ``phase_limit``, its sink row, ``build.TEAM_WARPS`` warps and
    production's schedule unless ``warps``, ``loop_weight`` or ``cap`` say
    otherwise, ``build.probe_physics_team_library``; ``fmad``: built with
    multiply-add contraction): every block in ``layout``, block-major in
    ``TEAM_TILE``-env tiles; any B row-major (lanes past B compute and store
    nothing).

    CPU tensors run the plain version (``soa.physics_step_rows`` with the
    cut and the sink); CUDA tensors launch the kernel of
    ``csrc/probe_physics_team.cuh`` on the current stream, or raise. Each
    launch counts in ``launches[name]``, by default
    ``k1_probe_name(..., team=True)``. The kernel sizes its shared memory at
    its first launch, so launch it once eagerly before capturing it in a
    CUDA graph."""
    B, dev = _check_physics_blocks(s, blocks, outs, layout, TEAM_TILE, 1)
    if dev.type == "cpu":
        rows = blocks if layout == ROW_MAJOR else [from_block_major(x) for x in blocks]
        want = soa.physics_step_rows(s, n_substeps, *rows, phase_limit=phase_limit, sink=True)
        for o, w in zip(outs, want):
            o.copy_(w if layout == ROW_MAJOR else to_block_major(w, TEAM_TILE))
        return
    if dev.type != "cuda":
        raise ValueError(f"physics_probe_team: unsupported device {dev}")
    lib = build.probe_physics_team_library(s, n_substeps, phase_limit, fmad, warps, loop_weight,
                                           cap)
    rows = (s.nq, s.nv, s.nu, s.ndr, s.ncache)
    build.launch_into("probe_physics_team", lib.probe_physics_team_launch,
                      list(blocks) + list(outs), B, layout, *rows)
    count_launch(name or k1_probe_name(phase_limit, layout, fmad, team=True))


def empty_outputs(s, B: int, device, layout: int = ROW_MAJOR, tile: int = TILE):
    """Preallocated output blocks (q, v, caches, sink) for ``physics_probe``
    (``tile``: ``TEAM_TILE`` for ``physics_probe_team``)."""
    shape = (lambda n: (n, B)) if layout == ROW_MAJOR else (lambda n: (B // tile, n, tile))
    return [torch.empty(shape(n), dtype=torch.float32, device=device)
            for n in probe_out_rows(s)]


COPY_MODES = ("q", "min", "full")  # csrc/probe_copy.cuh's operand sets, by mode int
COPY_EPS = 1e-7  # what a copy adds to q and v (dev/profile_overhead.py:90)
_COPY_BLOCKS = {"q": 1, "min": 2, "full": 4}  # input blocks of a mode, and output blocks


def copy_name(mode: str, B: int) -> str:
    """The launch name of one copy: ``copy_<mode>``, with ``_one_block``
    where the B envs fit one 128-thread block."""
    return f"copy_{mode}" + ("_one_block" if B <= TILE else "")


def copy_outputs(mode: str, blocks: Sequence[torch.Tensor], ncache: int = 0):
    """Preallocated outputs of ``copy_probe``: q's (and v's) shape, and for
    ``full`` ``ncache`` cache rows and the sink row."""
    q = blocks[0]
    outs = [torch.empty_like(x) for x in blocks[: 1 if mode == "q" else 2]]
    if mode == "full":
        outs += [q.new_empty((ncache, q.shape[1])), q.new_empty((1, q.shape[1]))]
    return outs


def _check_copy_blocks(mode: str, blocks, outs) -> Tuple[int, torch.device]:
    if mode not in COPY_MODES:
        raise ValueError(f"copy mode {mode!r} is not one of {COPY_MODES}")
    n = _COPY_BLOCKS[mode]
    if len(blocks) != n or len(outs) != n:
        raise ValueError(f"copy {mode}: expected {n} input and {n} output blocks, got "
                         f"{len(blocks)} and {len(outs)}")
    q = blocks[0]
    B, dev = q.shape[-1] if q.ndim else -1, q.device
    for i, x in enumerate(list(blocks) + list(outs)):
        if (x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != B
                or not x.is_contiguous() or x.device != dev):
            raise ValueError(f"copy {mode}, block {i}: {x.dtype} {tuple(x.shape)} on {x.device}, "
                             f"expected contiguous float32 (rows, {B}) on {dev}")
    if (outs[0].shape != q.shape or (n > 1 and outs[1].shape != blocks[1].shape)
            or (n == 4 and outs[3].shape[0] != 1)):
        raise ValueError(f"copy {mode}: the output rows do not match (q, v, caches, one sink row)")
    return B, dev


def copy_rows(mode: str, blocks: Sequence[torch.Tensor], outs: Sequence[torch.Tensor]):
    """The plain version of ``csrc/probe_copy.cuh`` into ``outs``: q (and
    v) + 1e-7; for ``full`` every cache row = q[0] and the sink row, the
    env's ctrl rows then its dr rows summed in order."""
    torch.add(blocks[0], COPY_EPS, out=outs[0])
    if mode == "q":
        return
    torch.add(blocks[1], COPY_EPS, out=outs[1])
    if mode == "min":
        return
    outs[2].copy_(blocks[0][:1].expand_as(outs[2]))
    sink = torch.zeros_like(outs[3][0])
    for x in blocks[2:]:
        for r in range(x.shape[0]):
            sink = sink + x[r]
    outs[3][0].copy_(sink)


def _copy(mode: str, blocks, outs, entry: str, name: str):
    B, dev = _check_copy_blocks(mode, blocks, outs)
    if dev.type == "cpu":
        copy_rows(mode, blocks, outs)
        return
    if dev.type != "cuda":
        raise ValueError(f"copy_probe: unsupported device {dev}")
    lib = build.probe_copy_library()
    fn = getattr(lib, entry)
    if fn.argtypes is None:  # the one-thread entry, bound at its first launch
        build._bind(lib, build.PROBE_COPY, True, entry)
    pad = [None] * (4 - len(blocks))  # operands the mode does not touch
    ins, outs = list(blocks) + pad, list(outs) + pad
    rows = [0 if x is None else x.shape[0] for x in ins + outs[2:3]]
    build.launch_into("probe_copy", fn, ins + outs, B, COPY_MODES.index(mode), *rows)
    count_launch(name)


def copy_probe(mode: str, blocks: Sequence[torch.Tensor], outs: Sequence[torch.Tensor]):
    """One copy of ``mode`` (``COPY_MODES``) into the preallocated ``outs``,
    every block ``(rows, B)``: ``q``: (q,) -> (q',); ``min``: (q, v) ->
    (q', v'); ``full``: (q, v, ctrl, dr) -> (q', v', caches, sink).

    CPU tensors run the plain version (``copy_rows``); CUDA tensors launch
    the element-parallel kernel of ``csrc/probe_copy.cuh`` (4 floats a
    thread, 128 threads per block) on the current stream, or raise. Each
    launch counts in ``launches[copy_name(mode, B)]``."""
    _copy(mode, blocks, outs, "probe_copy_launch", copy_name(mode, blocks[0].shape[-1]))


def copy_probe_one_thread(mode: str, blocks: Sequence[torch.Tensor],
                          outs: Sequence[torch.Tensor]):
    """``copy_probe`` through the one-thread copy of ``csrc/probe_copy.cuh``
    (one env per thread, its rows in a loop): the A/B baseline. Each launch
    counts in ``launches[copy_name(mode, B) + "[one-thread]"]``."""
    _copy(mode, blocks, outs, "probe_copy_one_thread_launch",
          copy_name(mode, blocks[0].shape[-1]) + "[one-thread]")


def check_copy(mode: str, blocks: Sequence[torch.Tensor], ncache: int = 0):
    """One ``copy_probe`` launch and one ``copy_probe_one_thread`` launch on
    the card, each held bit for bit against ``copy_rows`` on the same
    blocks; raises if an env differs. Returns (max abs err, differing envs,
    the plain version's ms) of ``copy_probe``."""
    want = copy_outputs(mode, blocks, ncache)
    plain_ms = window_ms(lambda: copy_rows(mode, blocks, want))
    for copy in (copy_probe_one_thread, copy_probe):  # copy_probe's result is returned
        got = copy_outputs(mode, blocks, ncache)
        copy(mode, blocks, got)
        err, differing = compare_exact(got, want)
        if differing:
            raise AssertionError(f"{copy.__name__} {mode}: {differing} of {blocks[0].shape[1]} "
                                 "envs differ from the plain version")
    return err, differing, plain_ms


def compare_exact(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]):
    """(max abs err, differing envs) of ``(rows, B)`` blocks held bit for
    bit (a NaN equals a NaN; a NaN against a number differs, at error
    inf)."""
    err, bad = 0.0, None
    for g, w in zip(got, want):
        differ = ~((g == w) | (torch.isnan(g) & torch.isnan(w)))
        diff = torch.where(differ, (g - w).abs().nan_to_num(math.inf), torch.zeros_like(g))
        err = max(err, float(diff.max()))
        bad = differ.any(0) if bad is None else bad | differ.any(0)
    return err, int(bad.sum())


def nominal_setup(device):
    """(s, n_substeps, model) of the default configuration's nominal env."""
    from puppax_torch.configs import EnvConfig
    from puppax_torch.env.pupper import PupperV3Env

    env = PupperV3Env.from_config(EnvConfig(), device=device)
    return env._s, env._n_substeps, env.model


def nominal_blocks(s, model, B: int, device):
    """The TPU probes' inputs (``dev/profile_kernel_phases.py:39-42``) as
    K1's ``(rows, B)`` blocks: the nominal model's qpos0 in every env, zero
    qvel, ctrl = qpos0[7:] and the nominal parameter rows."""
    qpos0 = torch.as_tensor(model.qpos0, dtype=torch.float32, device=device)
    q = qpos0[:, None].expand(s.nq, B).contiguous()
    v = torch.zeros((s.nv, B), dtype=torch.float32, device=device)
    ctrl = qpos0[7:, None].expand(s.nu, B).contiguous()
    dr = soa.dr_rows_block(s, soa.dr_inputs(model, s, B, device=device))
    return [q, v, ctrl, dr]


def ptxas_info(record: str) -> dict:
    """What ptxas reported for a build (its ``build.log``, ``-Xptxas -v``):
    ``registers``, ``stack``, ``spill_stores`` and ``spill_loads`` bytes,
    the largest of each over the functions of the log."""
    with open(f"{build.last_build[record]['dir']}/build.log") as f:
        return ptxas_of_log(f.read())


def ptxas_of_log(log: str) -> dict:
    """``ptxas_info`` of a build log's text."""
    found = {key: [int(x) for x in re.findall(pattern, log)] for key, pattern in (
        ("registers", r"Used (\d+) registers"), ("stack", r"(\d+) bytes stack frame"),
        ("spill_stores", r"(\d+) bytes spill stores"), ("spill_loads", r"(\d+) bytes spill loads"))}
    return {key: max(vals, default=0) for key, vals in found.items()}


def ptxas_functions(log: str) -> dict:
    """What ptxas reported for each entry function of a build log's text:
    (mangled) name -> ``ptxas_of_log`` of its lines plus ``smem``, its
    static shared bytes."""
    out = {}
    for part in re.split(r"Compiling entry function '", log)[1:]:
        name, text = part.split("'", 1)
        smem = re.search(r"(\d+) bytes smem", text)
        out[name] = dict(ptxas_of_log(text), smem=int(smem.group(1)) if smem else 0)
    return out


def print_builds(names: Sequence[str]):
    """One line per probe build (``build.last_build``) with its ptxas
    summary."""
    for name in names:
        info = build.last_build[name]
        print(f"build: {name}, {info['lines']} generated lines, {info['ops_per_env']} float "
              f"ops per env, nvcc {info['compile_seconds']:.1f} s on {info['host_cpus']} "
              f"host cpus, cached {info['cached']}", flush=True)
        with open(f"{info['dir']}/build.log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line or "stack frame" in line:
                    print("  ptxas:" + line.split(":", 1)[-1].rstrip())
