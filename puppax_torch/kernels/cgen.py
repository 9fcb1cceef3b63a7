"""CUDA C back-end of the value algebra: the emission as C source.

Every algebra value becomes a named C scalar (``float``; ``bool`` for
masks; ``int`` for the Illinois side) and every op appends one SSA line.
Constants print with ``repr`` digits of their float32 value and an ``f``
suffix, so no expression is promoted to double and each constant rounds
exactly as JAX's weak typing rounds it. ``fori_loop`` becomes a C ``for``
whose carries are declared before it; its body is emitted under a fresh
CSE scope, so no value born inside the loop is used after it. The stacked
one-sided rows of the line search become local ``float[n]`` arrays, and
their sum an ordered loop. A box model's loops over its box table
(``fori_loop(..., split=True)``) read the table (``box_at``, a constant
array in the preamble) and their input rows (``row_at``) at the loop
index, and pass rows to later stages through local ``float[n]`` arrays
stored and loaded at an index (``array``, ``array_store``, ``array_load``).

The generated body is one ``PUPPAX_HD`` (``__host__ __device__``) function
that reads row r of env b at ``ptr[r * B + b]``, after the constant grid
its ``grid_at`` reads, if any (the heightfield's: ``CProgram.preamble``);
a hand-written shell wraps it in the kernel and the C entry points:
``csrc/wrapped_step.cuh`` for the
wrapped step (K3), ``csrc/env_step.cuh`` for the unwrapped step (K2),
``csrc/physics_step.cuh`` for the physics-only step (K1), one env per
thread. The one-thread fused unroll (K4, ``csrc/fused_unroll.cuh``) calls
K3's body once per step. The production kernels are team kernels:
``kernels/team.py`` renders the same program split across the warps of a
block, inside ``csrc/wrapped_step_team.cuh``, ``csrc/env_step_team.cuh``,
``csrc/physics_step_team.cuh`` and ``csrc/fused_unroll_team.cuh`` (K3's
program, once per step of the unroll).

Beside its lines, ``CProgram`` records each statement as a node (``Val``,
``Load``, ``Store``, ``Stack``, ``Dphi``, ``Loop``, and a box model's
``Arr``, ``ArrStore``, ``ArrLoad`` and ``DynLoad``: name, kind, expression
template, operand names, loop nesting), which ``kernels/team.py`` schedules
across the warps of a block.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import numpy as np

from puppax_torch.physics import soa

_CTYPE = {"f": "float", "b": "bool", "i": "int"}
_UNARY = {
    "abs": "fabsf({})",
    "sign": "psign({})",
    "sqrt": "sqrtf({})",
    "rsqrt": "(1.0f / sqrtf({}))",
    "exp": "expf({})",
    "sin": "sinf({})",
    "cos": "cosf({})",
    "floor": "floorf({})",
}

# the pointer parameters of each body, in block order (shells: WS_PARAMS
# in common.cuh for wrapped_step.cuh, wrapped_step_team.cuh and the K4 shells,
# ES_PARAMS in env_step.cuh and env_step_team.cuh,
# PS_PARAMS in physics_step.cuh and physics_step_team.cuh)
IN_BLOCKS = ("q", "v", "act", "env", "noi", "dr", "first", "wrap")
OUT_BLOCKS = ("q_out", "v_out", "env_out", "wrap_out", "aux_out")
ENV_IN_BLOCKS = ("q", "v", "act", "env", "noi", "dr")
ENV_OUT_BLOCKS = ("q_out", "v_out", "cache_out", "env_out")
PHYSICS_IN_BLOCKS = ("q", "v", "ctrl", "dr")
PHYSICS_OUT_BLOCKS = ("q_out", "v_out", "cache_out")


def float_literal(x) -> str:
    """C literal of ``x`` rounded to float32 (round-to-nearest-even)."""
    f = float(np.float32(x))
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    text = repr(f)
    return f"({text}f)" if text.startswith("-") else f"{text}f"


class CVal:
    """One named C value (or literal) of a ``CProgram``."""

    __slots__ = ("_bk", "name", "kind")
    __hash__ = object.__hash__

    def __init__(self, bk: "CProgram", name: str, kind: str):
        self._bk = bk
        self.name = name
        self.kind = kind

    def _bin(self, other, op, rev=False, kind=None):
        bk = self._bk
        o = bk.arg(other, self.kind)
        a, b = (o, self.name) if rev else (self.name, o)
        return bk.emit(kind or self.kind, "{} " + op + " {}", a, b)

    def __add__(self, o):
        return self._bin(o, "+")

    def __radd__(self, o):
        return self._bin(o, "+", rev=True)

    def __sub__(self, o):
        return self._bin(o, "-")

    def __rsub__(self, o):
        return self._bin(o, "-", rev=True)

    def __mul__(self, o):
        return self._bin(o, "*")

    def __rmul__(self, o):
        return self._bin(o, "*", rev=True)

    def __truediv__(self, o):
        return self._bin(o, "/")

    def __rtruediv__(self, o):
        return self._bin(o, "/", rev=True)

    def __neg__(self):
        return self._bk.emit(self.kind, "-{}", self.name)

    def __lt__(self, o):
        return self._bin(o, "<", kind="b")

    def __le__(self, o):
        return self._bin(o, "<=", kind="b")

    def __gt__(self, o):
        return self._bin(o, ">", kind="b")

    def __ge__(self, o):
        return self._bin(o, ">=", kind="b")

    def __eq__(self, o):
        return self._bin(o, "==", kind="b")

    def __ne__(self, o):
        return self._bin(o, "!=", kind="b")

    def __and__(self, o):
        return self._bin(o, "&&", kind="b")

    def __or__(self, o):
        return self._bin(o, "||", kind="b")

    def __invert__(self):
        return self._bk.emit("b", "!{}", self.name)


class CArr:
    """A local ``float name[n]`` of stacked row values (or an indexed
    array of a box model's loops, with its back-end ``_bk``)."""

    __slots__ = ("name", "n", "_bk")

    def __init__(self, name: str, n: int, bk: "CProgram" = None):
        self.name = name
        self.n = n
        self._bk = bk


# ---- the statement nodes CProgram records beside its lines ----
class Val:
    """``const <kind> name = template.format(*args);`` (args: value names or
    literals)."""

    __slots__ = ("name", "kind", "template", "args")

    def __init__(self, name, kind, template, args):
        self.name, self.kind, self.template, self.args = name, kind, template, tuple(args)

    @property
    def expr(self) -> str:
        return self.template.format(*self.args)


class Load:
    """``const float name = ptr[row * B + b];``"""

    __slots__ = ("name", "ptr", "row")

    def __init__(self, name, ptr, row):
        self.name, self.ptr, self.row = name, ptr, row


class Store:
    """``ptr[row * B + b] = arg;``"""

    __slots__ = ("ptr", "row", "arg")

    def __init__(self, ptr, row, arg):
        self.ptr, self.row, self.arg = ptr, row, arg


class Stack:
    """``const float name[len(args)] = {args...};``"""

    __slots__ = ("name", "args")

    def __init__(self, name, args):
        self.name, self.args = name, tuple(args)


class Dphi:
    """The line search's row sum ``name`` = sum over r = 0..n-1, in order,
    of ``pmin(D[r] * (jar[r] + alpha * jv[r]), 0) * jv[r]`` over the stacked
    rows ``D``, ``jar``, ``jv`` (``CProgram.os_dphi``)."""

    __slots__ = ("name", "D", "jar", "jv", "alpha", "n")

    def __init__(self, name, D, jar, jv, alpha, n):
        self.name, self.D, self.jar, self.jv, self.alpha, self.n = name, D, jar, jv, alpha, n


class Loop:
    """A ``fori_loop`` of ``n`` trips: carries ``(name, kind, init)``, the
    body's nodes, and the body's new value of each carry (``new``). A loop
    whose body reads its index (a loop over the box table) names the index
    variable ``var``; ``split``: partition it across the warps whatever its
    weight (``kernels/team.py``)."""

    __slots__ = ("n", "carries", "body", "new", "var", "split")

    def __init__(self, n, carries):
        self.n, self.carries, self.body, self.new = n, carries, [], []
        self.var, self.split = None, False


class Arr:
    """``float name[n];``: an indexed array of per-env rows (a box model's)."""

    __slots__ = ("name", "n")

    def __init__(self, name, n):
        self.name, self.n = name, n


class ArrStore:
    """``arr[index] = arg;`` (``index``: a C int expression, a constant or
    one that reads a loop index)."""

    __slots__ = ("arr", "index", "arg")

    def __init__(self, arr, index, arg):
        self.arr, self.index, self.arg = arr, index, arg


class ArrLoad(Val):
    """``const float name = arr[index];``: a ``Val`` whose one operand is
    the array."""

    __slots__ = ("arr", "index")

    def __init__(self, name, arr, index):
        super().__init__(name, "f", "{}[" + index + "]", (arr,))
        self.arr, self.index = arr, index


class DynLoad(Val):
    """``const float name = ptr[(row0 + k * stride) * B + b];``: an input
    row at a loop index ``k`` (its operand, the loop variable)."""

    __slots__ = ()


class CProgram:
    """The C back-end: collects SSA lines for one function body."""

    def __init__(self):
        self.lines: List[str] = []
        self.depth = 1
        self.count = 0
        self.nodes: list = []  # the statement nodes, loops nested
        self._into = self.nodes  # where the next node goes (None: not recorded)
        self.grid = None  # the constant grid grid_at reads (one per program)
        self.table = None  # the constant table table_at reads (one per program)
        self.loaded: Dict[str, Load] = {}  # the input rows' loads by value name
        self.index_reads: set = set()  # the loop variables a value reads

    def _record(self, node):
        if self._into is not None:
            self._into.append(node)

    # ---- names and literals ----
    def fresh(self, prefix: str = "t") -> str:
        self.count += 1
        return f"{prefix}{self.count}"

    def line(self, text: str):
        self.lines.append("  " * self.depth + text)

    def arg(self, x, kind: str = "f") -> str:
        if isinstance(x, CVal):
            return x.name
        if isinstance(x, bool):
            return "true" if x else "false"
        if kind == "i" and isinstance(x, int):
            return str(int(x))
        return float_literal(x)

    def emit(self, kind: str, template: str, *args: str) -> CVal:
        """One SSA statement: ``template`` with its ``{}`` filled by ``args``
        (value names or literals)."""
        name = self.fresh()
        self.line(f"const {_CTYPE[kind]} {name} = {template.format(*args)};")
        self._record(Val(name, kind, template, args))
        return CVal(self, name, kind)

    def const(self, x) -> CVal:
        return CVal(self, float_literal(x), "f")

    def int_const(self, x) -> CVal:
        return CVal(self, str(int(x)), "i")

    def load(self, ptr: str, row: int) -> CVal:
        name = self.fresh()
        self.line(f"const float {name} = {ptr}[{row} * B + b];")
        self.loaded[name] = node = Load(name, ptr, row)
        self._record(node)
        return CVal(self, name, "f")

    def store(self, ptr: str, row: int, x):
        self.line(f"{ptr}[{row} * B + b] = {self.arg(x)};")
        self._record(Store(ptr, row, self.arg(x)))

    # ---- the ops of physics/soa.py's back-end interface ----
    @staticmethod
    def _kind(*xs) -> str:
        for x in xs:
            if isinstance(x, CVal):
                return x.kind
        return "i" if all(isinstance(x, int) for x in xs) else "f"

    def where(self, c, a, b):
        kind = self._kind(a, b)
        return self.emit(kind, "{} ? {} : {}", self.arg(c), self.arg(a, kind), self.arg(b, kind))

    def maximum(self, a, b):
        return self.emit("f", "pmax({}, {})", self.arg(a), self.arg(b))

    def minimum(self, a, b):
        return self.emit("f", "pmin({}, {})", self.arg(a), self.arg(b))

    def unary(self, name: str, x):
        return self.emit("f", _UNARY[name], self.arg(x))

    def pow_const(self, x, p: float):
        """``powf(x, p)`` for a constant exponent (``soa.pow_const``)."""
        return self.emit("f", "powf({}, " + float_literal(p) + ")", self.arg(x))

    def grid_at(self, grid, iv, iu, dv: int, du: int) -> CVal:
        """A read of the constant grid at row ``iv + dv``, column ``iu +
        du`` (``soa.grid_at``): ``hfield_at`` of the preamble, one value
        whose operands are ``iv`` and ``iu``."""
        if self.grid is None:
            self.grid = grid
        elif self.grid != grid:
            raise ValueError("a program reads one constant grid")
        return self.emit("f", "hfield_at({}, {}, " + f"{int(dv)}, {int(du)})",
                         self.arg(iv), self.arg(iu))

    def table_at(self, table, k: CVal, j: int) -> CVal:
        """``table[k][j]`` at the loop index ``k`` (``soa.table_at``):
        ``box_at`` of the preamble."""
        if self.table is None:
            self.table = table
        elif self.table != table:
            raise ValueError("a program reads one constant table")
        self.index_reads.add(k.name)
        return self.emit("f", "box_at({}, " + f"{int(j)})", k.name)

    def row_at(self, values, k: CVal, stride: int, j: int, n: int) -> CVal:
        """``values[j + k * stride]`` for k in [0, n) (``soa.row_at``):
        the values must be loads of one input block whose rows step by
        ``stride``; one read of the block at the trip's row."""
        loads = [values[j + t * stride] for t in range(n)]
        loads = [x if isinstance(x, Unloaded) else self.loaded.get(getattr(x, "name", None))
                 for x in loads]
        if any(ld is None for ld in loads) or any(
                ld.ptr != loads[0].ptr or ld.row != loads[0].row + t * stride
                for t, ld in enumerate(loads)):
            raise ValueError("row_at reads rows of one input block at a fixed stride")
        name = self.fresh()
        self.index_reads.add(k.name)
        template = f"{loads[0].ptr}[({{}} * {int(stride)} + {loads[0].row}) * B + b]"
        self.line(f"const float {name} = {template.format(k.name)};")
        self._record(DynLoad(name, "f", template, (k.name,)))
        return CVal(self, name, "f")

    def array(self, n: int) -> CArr:
        name = self.fresh("a")
        self.line(f"float {name}[{int(n)}];")
        self._record(Arr(name, int(n)))
        return CArr(name, int(n), self)

    def _index(self, j: int, k, stride: int) -> str:
        if k is None:
            return str(int(j))
        self.index_reads.add(k.name)
        return f"{k.name} * {int(stride)} + {int(j)}"

    def array_store(self, arr: CArr, x, j: int, k=None, stride: int = 0):
        index, arg = self._index(j, k, stride), self.arg(x)
        self.line(f"{arr.name}[{index}] = {arg};")
        self._record(ArrStore(arr.name, index, arg))

    def array_load(self, arr: CArr, j: int, k=None, stride: int = 0) -> CVal:
        name, index = self.fresh(), self._index(j, k, stride)
        self.line(f"const float {name} = {arr.name}[{index}];")
        self._record(ArrLoad(name, arr.name, index))
        return CVal(self, name, "f")

    def preamble(self) -> str:
        """The C the body needs before it: the grid ``grid_at`` reads, as
        float32 literals in memory order, in global memory on the card (a
        ``__device__ const`` array) and in a host array for the g++ build,
        and ``hfield_at``, which clips the indices as integers and reads the
        cell; then the table ``table_at`` reads, in constant memory on the
        card, and ``box_at``. Empty for a program without either."""
        return self._grid_preamble() + self._table_preamble()

    def _table_preamble(self) -> str:
        if self.table is None:
            return ""
        n, width = len(self.table), len(self.table[0])
        cells = ",\n  ".join(", ".join(float_literal(x) for x in row) for row in self.table)
        return (
            f"// The obstacle boxes' table, {n} rows of {width} float32 (each box's rotation\n"
            "// by rows, position and half-sizes): constant memory on the card, a host\n"
            "// array in the g++ build.\n"
            "#ifdef __CUDACC__\n"
            f"__constant__ float box_table_dev[{n * width}] = {{\n  {cells}}};\n"
            "#endif\n"
            f"static const float box_table_host[{n * width}] = {{\n  {cells}}};\n"
            "// table[k][j] at the loop index k\n"
            "PUPPAX_HD static inline float box_at(int k, int j) {\n"
            "#ifdef __CUDA_ARCH__\n"
            f"  return box_table_dev[k * {width} + j];\n"
            "#else\n"
            f"  return box_table_host[k * {width} + j];\n"
            "#endif\n"
            "}\n"
        )

    def _grid_preamble(self) -> str:
        if self.grid is None:
            return ""
        nrow, ncol = len(self.grid), len(self.grid[0])
        cells = ",\n  ".join(", ".join(float_literal(x) for x in row) for row in self.grid)
        return (
            f"// The heightfield's grid, {nrow} x {ncol} float32 in memory order (row 0 at\n"
            "// y = -ry): global memory on the card, a host array in the g++ build.\n"
            "#ifdef __CUDACC__\n"
            f"__device__ const float hfield_grid_dev[{nrow * ncol}] = {{\n  {cells}}};\n"
            "#endif\n"
            f"static const float hfield_grid_host[{nrow * ncol}] = {{\n  {cells}}};\n"
            "// grid[iv + dv][iu + du] at whole-number iv, iu, clipped to the cells\n"
            "PUPPAX_HD static inline float hfield_at(float iv, float iu, int dv, int du) {\n"
            "  int r = (int)iv, c = (int)iu;\n"
            f"  r = (r < 0 ? 0 : (r > {nrow - 2} ? {nrow - 2} : r)) + dv;\n"
            f"  c = (c < 0 ? 0 : (c > {ncol - 2} ? {ncol - 2} : c)) + du;\n"
            "#ifdef __CUDA_ARCH__\n"
            f"  return hfield_grid_dev[r * {ncol} + c];\n"
            "#else\n"
            f"  return hfield_grid_host[r * {ncol} + c];\n"
            "#endif\n"
            "}\n"
        )

    def stack(self, vals) -> CArr:
        name = self.fresh("a")
        args = [self.arg(v) for v in vals]
        self.line(f"const float {name}[{len(vals)}] = {{{', '.join(args)}}};")
        self._record(Stack(name, args))
        return CArr(name, len(vals))

    def os_dphi(self, D: CArr, jar: CArr, jv: CArr, alpha: CVal) -> CVal:
        acc, r = self.fresh("s"), self.fresh("r")
        self.line(f"float {acc} = 0.0f;")
        self.line(f"for (int {r} = 0; {r} < {jar.n}; ++{r}) {{")
        self.depth += 1
        into, self._into = self._into, None  # the row loop is one Dphi node
        m = self.emit("f", "{} * {}", alpha.name, f"{jv.name}[{r}]")
        ja = self.emit("f", "{} + {}", f"{jar.name}[{r}]", m.name)
        dj = self.emit("f", "{} * {}", f"{D.name}[{r}]", ja.name)
        t = self.emit("f", "pmin({}, 0.0f)", dj.name)
        p = self.emit("f", "{} * {}", t.name, f"{jv.name}[{r}]")
        self._into = into
        self.line(f"{acc} = {acc} + {p.name};")
        self.depth -= 1
        self.line("}")
        self._record(Dphi(acc, D.name, jar.name, jv.name, alpha.name, jar.n))
        return CVal(self, acc, "f")

    def fori_loop(self, n: int, body, carry, split: bool = False):
        kinds = [self._kind(x) for x in carry]
        names, inits = [], []
        for x, kind in zip(carry, kinds):
            name = self.fresh("c")
            inits.append(self.arg(x, kind))
            self.line(f"{_CTYPE[kind]} {name} = {inits[-1]};")
            names.append(name)
        loop = Loop(n, list(zip(names, kinds, inits)))
        self._record(loop)
        into, self._into = self._into, (loop.body if self._into is not None else None)
        it = self.fresh("i")
        loop.split = split
        self.line(f"for (int {it} = 0; {it} < {n}; ++{it}) {{")
        self.depth += 1
        with soa.cse_scope(fresh=True):
            new = body(CVal(self, it, "i"), [CVal(self, nm, k) for nm, k in zip(names, kinds)])
            # read every new value before any carry is assigned
            tmps = [self.emit(k, "{}", self.arg(x, k)) for x, k in zip(new, kinds)]
        loop.new = [t.name for t in tmps]
        if it in self.index_reads:
            loop.var = it
        self._into = into
        for nm, t in zip(names, tmps):
            self.line(f"{nm} = {t.name};")
        self.depth -= 1
        self.line("}")
        return [CVal(self, nm, k) for nm, k in zip(names, kinds)]


class Unloaded:
    """An input row the program reads only at a loop index (``row_at``):
    no load of its own, and no operand."""

    __slots__ = ("ptr", "row")

    def __init__(self, ptr, row):
        self.ptr, self.row = ptr, row


def _unread(s) -> set:
    """The (block, row) of the input rows a box model reads only at the box
    loop's index: the DR rows of the pairs of every box but the first
    (``soa.row_at``), so the body does not grow with the boxes."""
    return {("dr", r) for r in soa.indexed_dr_rows(s)}


def _program(in_blocks, out_blocks, in_rows, emit, unread=()) -> CProgram:
    """Run ``emit`` on the loads of every input row (``Unloaded`` for the
    rows of ``unread``) and store its outputs."""
    prog = CProgram()
    rows = [[Unloaded(ptr, r) if (ptr, r) in unread else prog.load(ptr, r) for r in range(n)]
            for ptr, n in zip(in_blocks, in_rows)]
    outs = emit(rows)
    for ptr, vals in zip(out_blocks, outs):
        for r, x in enumerate(vals):
            prog.store(ptr, r, x)
    return prog


def _body(name, params, in_blocks, out_blocks, in_rows, emit, what, unread=()) -> str:
    prog = _program(in_blocks, out_blocks, in_rows, emit, unread)
    header = (
        f"// Generated by puppax_torch/kernels/cgen.py from the {what},\n"
        f"// {prog.count} values. Do not edit.\n"
        + prog.preamble()
        + f"PUPPAX_HD inline void {name}({params}, int B, int b) {{\n"
    )
    return header + "\n".join(prog.lines) + "\n}\n"


def wrapped_step_body(s, es, n_substeps: int, episode_length: int) -> str:
    """C source of ``wrapped_step_body`` (K3): the wrapped-step emission of
    ``env/soa_env.py`` for this model and env configuration."""
    from puppax_torch.env import soa_env

    in_rows, _ = soa_env.block_rows(s, es)
    return _body(
        "wrapped_step_body", "WS_PARAMS", IN_BLOCKS, OUT_BLOCKS, in_rows,
        lambda rows: soa_env.emit_wrapped_rows(s, es, n_substeps, episode_length, rows),
        f"wrapped-step\n// emission: n_substeps={n_substeps}, episode_length={episode_length}",
        _unread(s),
    )


def wrapped_step_program(s, es, n_substeps: int, episode_length: int) -> CProgram:
    """K3's emission as a ``CProgram`` (its nodes: ``kernels/team.py``)."""
    from puppax_torch.env import soa_env

    in_rows, _ = soa_env.block_rows(s, es)
    return _program(IN_BLOCKS, OUT_BLOCKS, in_rows,
                    lambda rows: soa_env.emit_wrapped_rows(s, es, n_substeps, episode_length, rows),
                    _unread(s))


def _fused_unroll_defines(s, es) -> str:
    """The fused unroll's layout and head constants as ``#define``s, each
    float a ``float_literal`` of the plain version's constant."""
    from puppax_torch.env import fused_unroll, soa_env

    _, out_rows = soa_env.block_rows(s, es)
    obs_r0, hist = es.env_rows["obs_history"]
    ints = {
        "K4_NQ": s.nq, "K4_NV": s.nv, "K4_NU": s.nu, "K4_NENV": es.nenv_rows,
        "K4_NNOISE": es.nnoise_rows, "K4_NAUX": out_rows[4], "K4_OBS_R0": obs_r0,
        "K4_HIST": hist, "K4_DONE_ROW": soa_env.aux_row_map(es)["done"][0],
    }
    floats = {
        "K4_DPHASE": es.dphase, "K4_TWO_PI": soa_env.TWO_PI,
        "K4_MIN_STD": fused_unroll.MIN_STD, "K4_LOG2": fused_unroll.LOG2,
        "K4_HALF_LOG_2PI": fused_unroll.HALF_LOG_2PI,
        "K4_SOFTPLUS_THRESHOLD": fused_unroll.SOFTPLUS_THRESHOLD,
    }
    header = "// Generated by puppax_torch/kernels/cgen.py: the fused unroll's constants.\n"
    header += "".join(f"#define {k} {v}\n" for k, v in ints.items())
    return header + "".join(f"#define {k} {float_literal(v)}\n" for k, v in floats.items())


def fused_unroll_body(s, es, n_substeps: int, episode_length: int) -> str:
    """C source of the one-thread fused unroll's (K4) generated part: its
    constants (``_fused_unroll_defines``), then K3's ``wrapped_step_body``,
    which ``csrc/fused_unroll.cuh`` calls once per step."""
    return _fused_unroll_defines(s, es) + wrapped_step_body(s, es, n_substeps, episode_length)


def fused_unroll_team_body(s, es, n_substeps: int, episode_length: int, warps: int,
                           mlp_rows: int, mlp_only: bool = False, team_k3=None):
    """Team K4's generated part (shell ``csrc/fused_unroll_team.cuh``): the
    constants, ``K4_R`` (the MLP outputs a thread sums at once), then K3's
    program split across ``warps`` warps (``team.wrapped_step_team_body``,
    or ``team_k3``, its (source, stats) when already rendered).
    Returns (source, the schedule's stats). ``mlp_only`` (a probe variant)
    leaves the env step out: the shell then runs the observation, the MLP,
    the head and the clock alone, in a block with the whole kernel's shared
    memory (``team.SHARED_BUDGET``)."""
    from puppax_torch.kernels import team

    head = _fused_unroll_defines(s, es) + f"#define K4_R {int(mlp_rows)}\n"
    if mlp_only:  # with the whole kernel's shared memory, so L1 keeps what it keeps there
        return head + f"#define K4_MLP_ONLY 1\n#define TEAM_W {int(warps)}\n" \
            f"#define TEAM_SHARED_FLOATS {team.SHARED_BUDGET // 4}\n", \
            {"warps": int(warps), "ops_per_env": 0}
    body, stats = team_k3 or team.wrapped_step_team_body(s, es, n_substeps, episode_length,
                                                         warps)
    return head + body, stats


def env_step_body(s, es, n_substeps: int) -> str:
    """C source of ``env_step_body`` (K2): the unwrapped env-step emission
    plus the last forward pass's caches (``soa_env.emit_env_rows``)."""
    from puppax_torch.env import soa_env

    in_rows, _ = soa_env.env_block_rows(s, es)
    return _body(
        "env_step_body", "ES_PARAMS", ENV_IN_BLOCKS, ENV_OUT_BLOCKS, in_rows,
        lambda rows: soa_env.emit_env_rows(s, es, n_substeps, rows),
        f"env-step\n// emission: n_substeps={n_substeps}",
        _unread(s),
    )


def env_step_program(s, es, n_substeps: int) -> CProgram:
    """K2's emission as a ``CProgram`` (its nodes: ``kernels/team.py``)."""
    from puppax_torch.env import soa_env

    in_rows, _ = soa_env.env_block_rows(s, es)
    return _program(ENV_IN_BLOCKS, ENV_OUT_BLOCKS, in_rows,
                    lambda rows: soa_env.emit_env_rows(s, es, n_substeps, rows), _unread(s))


def physics_step_program(s, n_substeps: int, phase_limit=None, sink: bool = False) -> CProgram:
    """K1's emission as a ``CProgram`` (its nodes: ``kernels/team.py``).
    ``phase_limit`` and ``sink`` as in ``physics_step_body``: the program
    cut after that phase and, with ``sink``, the output block ``sink_out``
    (the team probes' program, ``team.physics_step_team_body``)."""
    in_rows, _ = soa.physics_block_rows(s)
    return _program(PHYSICS_IN_BLOCKS, PHYSICS_OUT_BLOCKS + (("sink_out",) if sink else ()),
                    in_rows,
                    lambda rows: soa.emit_physics_rows(s, n_substeps, rows, phase_limit, sink),
                    _unread(s))


def physics_step_body(s, n_substeps: int, phase_limit=None, sink: bool = False) -> str:
    """C source of ``physics_step_body`` (K1): the physics-only emission
    (``soa.emit_physics_rows``: the substeps, the last forward pass's caches
    and the final integrate). ``phase_limit`` (one of ``soa.PHASES``) emits
    the program cut after that phase, for the kernel-time probes; the
    header comment names the cut. ``sink`` (the probes' shell,
    ``csrc/probe_physics.cuh``) adds the output block ``sink_out``, one row
    that keeps every value of the cut pass live."""
    in_rows, _ = soa.physics_block_rows(s)
    cut = "" if phase_limit is None else f", cut after phase {phase_limit}"
    return _body(
        "physics_step_body", "PP_PARAMS" if sink else "PS_PARAMS", PHYSICS_IN_BLOCKS,
        PHYSICS_OUT_BLOCKS + (("sink_out",) if sink else ()), in_rows,
        lambda rows: soa.emit_physics_rows(s, n_substeps, rows, phase_limit, sink),
        f"physics-step\n// emission: n_substeps={n_substeps}{cut}{', sink row' if sink else ''}",
        _unread(s),
    )


_LOOP = re.compile(r"for \(int \w+ = 0; \w+ < (\d+); \+\+\w+\) \{$")
_OPS = re.compile(
    r"(?<![eE])[-+*/](?![=+])|[<>]=?|[!=]="
    r"|\b(?:sqrtf|expf|sinf|cosf|powf|fabsf|floorf|pmax|pmin|psign)\("
)
# a declaration (value, carry, accumulator or stacked array), an assignment
# of a carry or accumulator, a store into an output block
_DECL = re.compile(r"(?:const )?(?:float|bool|int) (\w+)(?:\[\d+\])? = (.*);$")
_ASSIGN = re.compile(r"(\w+) = (.*);$")
_STORE = re.compile(r"\w+\[[^\]]*\* B \+ b\] = (.*);$")
_ARR_STORE = re.compile(r"(\w+)\[[^\]]*\] = (.*);$")  # an indexed array's element
_NAME = re.compile(r"\b[a-z]\d+\b")  # the names CProgram.fresh makes


def expr_ops(rhs: str) -> int:
    """Float operations of one C expression, as ``op_count`` counts them."""
    rhs = re.sub(r"\w+\[[^\]]*\]", "x", rhs)  # indices are not float work
    rhs = re.sub(r"(?<![\w.])\(?-?\d+(?:\.\d*)?(?:e[+-]?\d+)?f\)?", "c", rhs)  # literals
    return len(_OPS.findall(rhs))


def op_count(body: str) -> int:
    """Float operations one env's run of a generated body performs: every
    arithmetic operator, comparison, min/max, sign and math-library call,
    each line weighted by the trip counts of the loops around it (the
    substep loop and the line search's expand / Illinois / row loops).
    Only lines whose value reaches a store count, as nvcc drops the rest
    (a phase cut pads the outputs it has not reached, so the values only
    those would read are dead). Loads, stores, selects and the loop
    counters are not counted."""
    defs: Dict[str, List[int]] = {}  # name -> the lines that set it
    uses, ops, roots = [], [], []
    trips = [1]
    for line in body.splitlines():
        line = re.sub(r"//.*", "", line).strip()
        m = _LOOP.match(line)
        if m:
            trips.append(trips[-1] * int(m.group(1)))
            continue
        if line == "}":
            if len(trips) > 1:
                trips.pop()
            continue
        if line.startswith(("PUPPAX_HD", "#")):
            continue
        m = _STORE.match(line)
        if m:
            roots.extend(_NAME.findall(m.group(1)))
            continue
        m = _DECL.match(line) or _ASSIGN.match(line) or _ARR_STORE.match(line)
        if not m:
            continue
        rhs = m.group(2)
        defs.setdefault(m.group(1), []).append(len(ops))
        uses.append(_NAME.findall(rhs))
        ops.append(trips[-1] * expr_ops(rhs))
    live, todo, seen = set(), list(roots), set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for i in defs.get(name, ()):
            live.add(i)
            todo.extend(uses[i])
    return sum(ops[i] for i in live)
