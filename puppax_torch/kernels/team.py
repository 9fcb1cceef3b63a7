"""Warp-partitioned ("team") rendering of a generated kernel body.

The one-thread kernels (``csrc/physics_step.cuh``, ``csrc/env_step.cuh``)
run one env's whole straight-line program in one thread. A team kernel
runs 32 envs per block, one per lane, and splits each env's program across
the block's ``W`` warps: every warp runs its own stream of the program's
statements for the 32 envs of its lanes.

``Schedule`` takes the statement nodes that ``cgen.CProgram`` records
(``Val``, ``Load``, ``Store``, ``Stack``, ``Dphi``, ``Loop``) and builds
the W streams:

* Straight-line code is cut into stages separated by barriers. A statement
  goes to the warp (and the earliest stage) where its operands are: its
  own warp's values of any earlier or the same stage, other warps' values
  of earlier stages. Ties go to the warp that holds most operands, then to
  the least loaded one; a warp takes at most ``cap`` weighted operations a
  stage, which spreads the work.
* A value that another warp reads goes through shared memory,
  ``sh[slot][32]`` with the lane fastest (no bank conflicts), written by
  its owner as soon as it is computed, or just before its first foreign
  read where the slots would not fit in ``SHARED_BUDGET`` (an early write
  frees the owner's register). Slots are reused by liveness.
* Input rows are read from global memory by each warp at each use; outputs
  are stored by the warp that holds the value.
* Loops run in every warp with the same trip counts. A small loop (the
  line search's expand and Illinois loops) runs whole in every warp, its
  carries in registers: its scalar work is replicated. A large loop (the
  substep ``fori_loop``) is partitioned like straight-line code; its
  carries live in shared slots, rewritten between two barriers at the end
  of each trip. Small means a body weight of at most ``loop_weight``
  (``REPLICATED_LOOP_WEIGHT`` in production; a probe may lower it).
* Statements whose operands are all replicated values are replicated too.
* ``Dphi`` (the line search's row sum over the 140 one-sided rows): each
  warp computes the terms of its range of rows into a double-buffered
  shared array ``[2][rows][32]``; one barrier; then every warp sums all
  rows in the order r = 0..rows-1, the plain version's order (its loop
  unrolled by ``SUM_UNROLL``, so loads run ahead of the dependent adds).
  The stacked rows (``Stack``) live in shared memory.
* A box model's loops over its box table (``Loop.split``) are partitioned
  whatever their weight; a table read or an input row read at the loop
  index has no operand but the index and is replicated. Its indexed arrays
  (``Arr``: the rows one loop passes to a later stage, and the line
  search's stacked rows, ~780 of them for 20 boxes) do not fit in shared
  memory: they live in a per-launch scratch in global memory,
  ``SCR(row)`` of ``TEAM_SCRATCH_ROWS`` rows per 32-env group, the lane
  fastest (``csrc/team.cuh``), and so do the row terms of the sums over
  them. A store goes to the warp that holds the value; a read of an array
  (a load, a loop or a row sum) is placed after every store before it in
  program order, a barrier between (a loop ends with one).

``render`` writes the streams as one ``TEAM_FN`` (``__device__``) function with a
``switch (warp)``, each warp's whole stream in its own ``case`` (so nvcc
computes each stream's liveness on its own), barriers as ``TEAM_BAR()``
(``bar.sync 1, 32 * W`` on the card, a ``std::barrier`` on the host; see
``csrc/team.cuh``) at the same count in every stream.

Every operation is the one-thread program's operation on the same operands,
so a team kernel is bit for bit with its one-thread kernel and the plain
version (``--fmad=false``, the in-order row sums).
"""

from __future__ import annotations

import heapq
import re
from typing import Dict, List, Optional, Tuple

from puppax_torch.kernels import cgen

LANES = 32
# owners besides a warp index
REPL, SHARED, INLINE, STACK, ARR = -1, -2, -3, -4, -5
# a loop whose body (row sums aside) weighs no more runs whole in every warp
REPLICATED_LOOP_WEIGHT = 4000
# shared memory one block may use: Hopper's 227 KB
SHARED_BUDGET = 232448
# the unroll pragma of a row sum's in-order adds (0: nvcc's choice, -1:
# whole, k: by k; chosen on the card, probes/profile_team.py): k loads in
# flight ahead of the dependent adds
SUM_UNROLL = 35
# the per-warp budget of a stage, in weighted operations, and the cost, in
# stages, of sending one more operand through shared memory (chosen on the
# CPU by the modelled stream length and the shared memory they need)
CAP = 48
CROSS = 1.0

_SLOW = re.compile(r"\b(?:sinf|cosf|expf|powf)\(")
_MID = re.compile(r"\bsqrtf\(|/")


def weight(expr: str) -> int:
    """Balancing weight of one expression: its float operations, with a
    division or square root as 8 and sin, cos, exp or pow as 20 (their
    correctly rounded sequences); a plain copy weighs 0."""
    ops = cgen.expr_ops(expr)
    if ops == 0:
        return 0 if re.fullmatch(r"[\w.()-]+", expr) else 1
    return ops + 7 * len(_MID.findall(expr)) + 19 * len(_SLOW.findall(expr))


class _Info:
    """Where a value lives: its owner (a warp, or ``REPL``, ``SHARED``,
    ``INLINE``, ``STACK``), its stage and region, whether a barrier-bearing
    item made it (``sync``), its C kind and its shared slot."""

    __slots__ = ("owner", "stage", "region", "sync", "kind", "slot")

    def __init__(self, owner, stage, region, sync=False, kind="f"):
        self.owner, self.stage, self.region, self.sync, self.kind = owner, stage, region, sync, kind
        self.slot = None


class _Sync:
    """A barrier-bearing item every warp runs: a row sum, a replicated
    loop or a partitioned loop."""

    __slots__ = ("what", "node", "body", "init_writers", "new_writers", "start", "end")

    def __init__(self, what, node):
        self.what, self.node = what, node
        self.body = None
        self.init_writers: List[int] = []
        self.new_writers: List[int] = []
        self.start = self.end = 0


class _Stage:
    __slots__ = ("syncs", "entries", "load", "epoch")

    def __init__(self, warps):
        self.syncs: List[_Sync] = []
        self.entries: List[tuple] = []  # (warp or REPL, item)
        self.load = [0] * warps
        self.epoch = 0


class _Region:
    __slots__ = ("rid", "path", "stages")

    def __init__(self, rid, path):
        self.rid, self.path = rid, path
        self.stages: List[_Stage] = []


def _walk(nodes):
    for n in nodes:
        yield n
        if isinstance(n, cgen.Loop):
            yield from _walk(n.body)


class Schedule:
    """The W streams of one program (see the module docstring)."""

    def __init__(self, prog: cgen.CProgram, warps: int, cap: int = CAP,
                 cross: float = CROSS, shared_budget: int = SHARED_BUDGET,
                 loop_weight: int = REPLICATED_LOOP_WEIGHT):
        self.W = warps
        self.cap = cap
        self.loop_weight = loop_weight
        self.cross = cross
        self.shared_budget = shared_budget
        self._readers: Dict[str, set] = {}  # value -> the other warps that read it
        self.nodes = prog.nodes
        self.info: Dict[str, _Info] = {}
        self.regions: List[_Region] = []
        self.loads: Dict[str, cgen.Load] = {}
        self.stack_len: Dict[str, int] = {}
        self.arr_base: Dict[str, int] = {}  # indexed array -> its first scratch row
        self.scratch_rows = 0
        self._astores = 0
        self._free: Dict[int, set] = {}
        self._sole: Dict[str, Optional[cgen.Val]] = {}  # name -> its one reader, if one
        self._defined = self._definitions()
        self.live = self._liveness()
        for n in _walk(self.nodes):
            if not isinstance(n, cgen.Val):
                for a in self._uses(n):
                    self._sole[a] = None
        self._schedule_region(self.nodes, ())
        # the row terms of the sums over arrays, double-buffered, after the arrays
        arr_sums = [n.n for n in _walk(self.nodes) if isinstance(n, cgen.Dphi)
                    and n.D in self.arr_base and self.is_live(n)]
        self.term_base = self.scratch_rows
        self.scratch_rows += 2 * max(arr_sums, default=0)
        for reg in self.regions:
            reg.stages = [st for st in reg.stages if st.syncs or st.entries]
        self.epochs = 0
        self._number(self.regions[0])
        self._allocate()

    # ---- analysis ----
    def _definitions(self) -> set:
        names = set()
        for n in _walk(self.nodes):
            if isinstance(n, (cgen.Val, cgen.Load, cgen.Stack, cgen.Dphi, cgen.Arr)):
                names.add(n.name)
            elif isinstance(n, cgen.Loop):
                names.update(c for c, _, _ in n.carries)
        return names

    def _names(self, args):
        return [a for a in args if a in self._defined]

    def _liveness(self) -> set:
        deps: Dict[str, List[str]] = {}
        roots = []
        for n in _walk(self.nodes):
            if isinstance(n, cgen.Val):
                deps[n.name] = self._names(n.args)
            elif isinstance(n, cgen.Load):
                deps[n.name] = []
            elif isinstance(n, cgen.Stack):
                deps[n.name] = self._names(n.args)
            elif isinstance(n, cgen.Dphi):
                deps[n.name] = self._names((n.D, n.jar, n.jv, n.alpha))
            elif isinstance(n, cgen.Loop):
                for (c, _, init), new in zip(n.carries, n.new):
                    deps[c] = self._names((init, new))
            elif isinstance(n, cgen.Store):
                roots.extend(self._names((n.arg,)))
            elif isinstance(n, cgen.Arr):
                deps.setdefault(n.name, [])
            elif isinstance(n, cgen.ArrStore):  # an array is live with what it holds
                deps.setdefault(n.arr, []).extend(self._names((n.arg,)))
        live, todo = set(), roots
        while todo:
            a = todo.pop()
            if a not in live:
                live.add(a)
                todo.extend(deps[a])
        return live

    def _uses(self, n) -> List[str]:
        if isinstance(n, cgen.Val):
            return self._names(n.args)
        if isinstance(n, cgen.Stack):
            return self._names(n.args)
        if isinstance(n, cgen.Dphi):
            return self._names((n.D, n.jar, n.jv, n.alpha))
        if isinstance(n, (cgen.Store, cgen.ArrStore)):
            return self._names((n.arg,))
        if isinstance(n, cgen.Loop):
            return sorted(self.free(n))
        return []

    def free(self, loop: cgen.Loop) -> set:
        """Names a loop reads that are defined outside it (its carries'
        initial values included)."""
        key = id(loop)
        if key not in self._free:
            inside, used = {c for c, _, _ in loop.carries}, set()
            for n in loop.body:
                used.update(self._uses(n))
                if isinstance(n, cgen.Loop):
                    inside.update(c for c, _, _ in n.carries)
                elif not isinstance(n, (cgen.Store, cgen.ArrStore)):
                    inside.add(n.name)
            used.update(self._names(init for _, _, init in loop.carries))
            self._free[key] = used - inside
        return self._free[key]

    def is_live(self, n) -> bool:
        if isinstance(n, cgen.Store):
            return True
        if isinstance(n, cgen.ArrStore):
            return n.arr in self.live
        if isinstance(n, cgen.Loop):
            return (any(c in self.live for c, _, _ in n.carries)
                    or any(self.is_live(m) for m in _walk(n.body) if isinstance(m, cgen.ArrStore)))
        return n.name in self.live

    # ---- scheduling ----
    def _stage(self, reg: _Region, k: int) -> _Stage:
        while len(reg.stages) <= k:
            reg.stages.append(_Stage(self.W))
        return reg.stages[k]

    def _avail(self, a: str, reg: _Region, w: int) -> int:
        """The earliest stage of ``reg`` at which warp ``w`` can read ``a``."""
        inf = self.info[a]
        if inf.region != reg.rid or inf.owner == INLINE:
            return 0
        if inf.owner in (REPL, SHARED, ARR) or inf.owner == w:
            return inf.stage
        return inf.stage + 1

    def _sync_stage(self, names, reg: _Region, floor: int) -> int:
        """The stage of a barrier-bearing item: after every input's writes."""
        k = floor
        for a in names:
            inf = self.info[a]
            if inf.region != reg.rid or inf.owner == INLINE:
                continue
            if inf.owner in (REPL, SHARED, ARR) and inf.sync:
                k = max(k, inf.stage)
            else:
                k = max(k, inf.stage + 1)
        return k

    def _schedule_region(self, nodes, path) -> _Region:
        reg = _Region(len(self.regions), path)
        self.regions.append(reg)
        W, last_sync = self.W, 0
        for n in nodes:
            if isinstance(n, cgen.Val) and n.name in self.live:
                for a in self._names(n.args):
                    self._sole[a] = n if a not in self._sole else None
        for n in nodes:
            if not self.is_live(n):
                continue
            if isinstance(n, cgen.Load):
                self.info[n.name] = _Info(INLINE, 0, reg.rid)
                self.loads[n.name] = n
            elif isinstance(n, cgen.Val):
                self._schedule_val(n, reg)
            elif isinstance(n, cgen.Store):
                self._place_write(reg, n.arg, n.row, ("store", n))
            elif isinstance(n, cgen.Stack):
                ks = [self.info[a].stage for a in self._names(n.args)
                      if self.info[a].region == reg.rid and self.info[a].owner != INLINE]
                k_stack = max(ks, default=0)
                for r, a in enumerate(n.args):
                    self._place_write(reg, a, r, ("stackw", n.name, r, a), k_stack)
                self.info[n.name] = _Info(STACK, k_stack, reg.rid)
                self.stack_len[n.name] = len(n.args)
            elif isinstance(n, cgen.Dphi):
                k = self._sync_stage(self._uses(n), reg, last_sync)
                last_sync = k
                self._stage(reg, k).syncs.append(_Sync("dphi", n))
                self.info[n.name] = _Info(REPL, k, reg.rid, sync=True)
            elif isinstance(n, cgen.Loop):
                k = self._sync_stage(self.free(n), reg, last_sync)
                last_sync = k
                sy = self._schedule_loop(n, reg, path, k)
                self._stage(reg, k).syncs.append(sy)
                for m in _walk(n.body):  # its stores are read after its last barrier
                    if isinstance(m, cgen.ArrStore) and self.is_live(m):
                        self._array_ready(m.arr, reg, k)
            elif isinstance(n, cgen.Arr):
                self.info[n.name] = _Info(ARR, 0, reg.rid, sync=True)
                self.arr_base[n.name] = self.scratch_rows
                self.scratch_rows += n.n
            elif isinstance(n, cgen.ArrStore):
                self._astores += 1
                k = self._place_write(reg, n.arg, self._astores, ("astore", n))
                self._array_ready(n.arr, reg, k + 1)
        return reg

    def _array_ready(self, arr: str, reg: _Region, k: int):
        """An array written in region ``reg`` is read from stage ``k`` on."""
        inf = self.info[arr]
        if inf.region == reg.rid:
            inf.stage = max(inf.stage, k)

    def _place_write(self, reg, a, row, item, late=0):
        """Place a write of ``a`` (an output store or a stacked row): by its
        owner at its stage; a replicated value or a carry by warp
        ``row % W`` at its stage; a literal, an input row or an outer value
        by warp ``row % W`` at stage ``late``."""
        inf = self.info.get(a)
        if inf is None or inf.owner == INLINE or inf.region != reg.rid:
            w, k = (inf.owner if inf is not None and inf.owner >= 0 else row % self.W), late
        else:
            w, k = (inf.owner if inf.owner >= 0 else row % self.W), inf.stage
        self._stage(reg, k).entries.append((w, item))
        return k

    def _schedule_val(self, n: cgen.Val, reg: _Region):
        W = self.W
        args = self._names(n.args)
        kind = n.kind
        if all(self.info[a].owner == REPL for a in args):
            k = max((self.info[a].stage if self.info[a].region == reg.rid else 0
                     for a in args), default=0)
            self._stage(reg, k).entries.append((REPL, ("val", n)))
            self.info[n.name] = _Info(REPL, k, reg.rid, kind=kind)
            return
        wt = weight(n.expr)
        # a value with one reader whose other operands sit on one warp goes
        # there if that does not delay the reader (a product feeding a sum)
        target, k_other = None, 0
        reader = self._sole.get(n.name)
        if reader is not None:
            others = [self.info.get(a) for a in self._names(reader.args) if a != n.name]
            if others and all(i is not None for i in others):
                owners = {i.owner for i in others if i.owner >= 0 and i.region == reg.rid}
                if len(owners) == 1:
                    target = owners.pop()
                    k_other = max(self._avail(a, reg, target)
                                  for a in self._names(reader.args) if a != n.name)
        best = None
        for w in range(W):
            k = max((self._avail(a, reg, w) for a in args), default=0)
            while wt and k < len(reg.stages) and reg.stages[k].load[w] + wt > self.cap:
                k += 1
            load = reg.stages[k].load[w] if k < len(reg.stages) else 0
            own = sum(1 for a in args if self.info[a].owner == w)
            # operands this placement would newly send through shared memory
            cross = self.cross * sum(1 for a in args if 0 <= self.info[a].owner != w
                                     and w not in self._readers.get(a, ()))
            k_reader = 0 if target is None else max(k_other, k + (w != target))
            key = (k_reader + cross, k + cross, -own, load, w)
            if best is None or key < best:
                best, k_best, w_best = key, k, w
        k, w = k_best, w_best
        for a in args:
            if 0 <= self.info[a].owner != w:
                self._readers.setdefault(a, set()).add(w)
        st = self._stage(reg, k)
        st.load[w] += wt
        st.entries.append((w, ("val", n)))
        self.info[n.name] = _Info(w, k, reg.rid, kind=kind)

    def _schedule_loop(self, loop: cgen.Loop, reg: _Region, path, k: int) -> _Sync:
        body_weight = sum(weight(n.expr) for n in loop.body if isinstance(n, cgen.Val))
        if body_weight <= self.loop_weight and not loop.split:
            self._replicate(loop, reg, k)
            return _Sync("rloop", loop)
        sy = _Sync("ploop", loop)
        for j, (c, kind, init) in enumerate(loop.carries):
            inf = self.info.get(init)
            own = inf is not None and inf.owner >= 0 and inf.region == reg.rid
            sy.init_writers.append(inf.owner if own else j % self.W)
        for c, kind, _ in loop.carries:
            self.info[c] = _Info(SHARED, k, reg.rid, sync=True, kind=kind)
        body = self._schedule_region(loop.body, path + (id(loop),))
        sy.body = body
        for j, new in enumerate(loop.new):
            inf = self.info.get(new)
            own = inf is not None and inf.owner >= 0
            sy.new_writers.append(inf.owner if own else j % self.W)
        return sy

    def _replicate(self, loop: cgen.Loop, reg: _Region, k: int):
        for n in _walk(loop.body):
            if isinstance(n, cgen.Loop):
                for c, kind, _ in n.carries:
                    self.info[c] = _Info(REPL, k, reg.rid, sync=True, kind=kind)
            elif isinstance(n, (cgen.Val, cgen.Dphi)):
                self.info[n.name] = _Info(REPL, k, reg.rid, sync=True,
                                          kind=getattr(n, "kind", "f"))
            else:
                raise ValueError(f"replicated loop holds a {type(n).__name__}")
        for c, kind, _ in loop.carries:
            self.info[c] = _Info(REPL, k, reg.rid, sync=True, kind=kind)

    # ---- barriers and shared slots ----
    def _number(self, reg: _Region):
        """Number the epochs (the spans between barriers) in render order."""
        for k, st in enumerate(reg.stages):
            if k:
                self.epochs += 1
            for sy in st.syncs:
                sy.start = self.epochs
                if sy.what == "dphi":
                    self.epochs += 1
                elif sy.what == "rloop":
                    self.epochs += sum(isinstance(n, cgen.Dphi) for n in _walk(sy.node.body)
                                       if self.is_live(n))
                else:
                    self.epochs += 1
                    self._number(sy.body)
                    self.epochs += 2
                sy.end = self.epochs
            st.epoch = self.epochs

    def _consumers(self):
        """(name, reading warp or REPL, first and last epoch of the reads,
        loops around them) for every read outside the value's own stream."""
        out = []
        loops: Dict[int, _Sync] = {}

        def region(reg):
            for st in reg.stages:
                for sy in st.syncs:
                    loops[id(sy.node)] = sy
                    if sy.what == "dphi":
                        for a in self._uses(sy.node):
                            out.append((a, REPL, sy.start, sy.end, reg.path))
                    elif sy.what == "rloop":
                        for a in sorted(self.free(sy.node)):  # the same text in every process
                            out.append((a, REPL, sy.start, sy.end, reg.path + (id(sy.node),)))
                    else:
                        for (c, _, init), w in zip(sy.node.carries, sy.init_writers):
                            for a in self._names((init,)):
                                out.append((a, w, sy.start, sy.start, reg.path))
                        region(sy.body)
                for w, item in st.entries:
                    if item[0] == "val":
                        names = self._names(item[1].args)
                    elif item[0] in ("store", "astore"):
                        names = self._names((item[1].arg,))
                    else:
                        names = self._names((item[3],))
                    for a in names:
                        out.append((a, w, st.epoch, st.epoch, reg.path))

        region(self.regions[0])
        return out, loops

    def _allocate(self):
        """Give every value that another warp reads a shared slot, written by
        its owner in the last stage before the first such read and free
        after the last (a read inside a loop the value is defined outside
        of counts as a read over the whole loop)."""
        uses, loops = self._consumers()
        defs: Dict[str, Tuple[_Region, int]] = {}  # value -> (region, stage index)
        start: Dict[str, int] = {}
        first: Dict[str, int] = {}
        end: Dict[str, int] = {}
        for reg in self.regions:
            for k, st in enumerate(reg.stages):
                for w, item in st.entries:
                    if item[0] == "val":
                        defs[item[1].name] = (reg, k)
                    elif item[0] == "stackw":
                        nm = item[1]
                        defs[nm] = (reg, k)
                        start[nm] = min(start.get(nm, st.epoch), st.epoch)
                for sy in st.syncs:
                    if sy.what == "ploop":
                        for c, _, _ in sy.node.carries:
                            defs[c] = (reg, k)
                            start[c] = sy.start
                            end[c] = sy.end
        for a, w, e0, e1, upath in uses:
            inf = self.info[a]
            if inf.owner in (REPL, INLINE, ARR) or inf.owner == w:
                continue
            dpath = defs[a][0].path
            for lid in upath:
                if lid not in dpath:
                    e0, e1 = min(e0, loops[lid].start), max(e1, loops[lid].end)
                    break
            first[a] = min(first.get(a, e0), e0)
            end[a] = max(end.get(a, e1), e1)
        stacks = sorted((start[a], e, a) for a, e in end.items() if self.info[a].owner == STACK)
        self.stack_rows = _scan_rows(stacks, self.info, self.stack_len)
        # the last stage before each value's first foreign read
        late = {}
        for a in end:
            if self.info[a].owner >= 0:
                reg, k = defs[a]
                while k + 1 < len(reg.stages) and reg.stages[k + 1].epoch < first[a]:
                    k += 1
                late[a] = k

        def place(gap):
            """Write a value at its definition, or, where its first foreign
            read is more than ``gap`` epochs later, in the stage before that
            read; returns the slots used."""
            writes, scalars = {}, []
            for a, e in end.items():
                inf = self.info[a]
                if inf.owner == STACK:
                    continue
                if inf.owner >= 0:
                    reg, k = defs[a]
                    if first[a] - reg.stages[k].epoch > gap:
                        k = late[a]
                    writes.setdefault((reg.rid, k), []).append(a)
                    start[a] = reg.stages[k].epoch
                scalars.append((start[a], e, a))
            self.slot_writes = writes  # (region, stage) -> the values written there
            return _scan_slots(sorted(scalars), self.info)

        # as early as the shared memory allows (an early write frees the
        # owner's register): the largest gap whose slots fit the budget
        room = self.shared_budget // (4 * LANES) - self.stack_rows - 2 * self.rows_max
        lo, hi = -1, self.epochs + 1  # place(lo) fits (every write late); place(hi) is eager
        if place(hi) > room:
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if place(mid) <= room else (lo, mid)
            hi = lo
        self.n_slots = place(hi)
        self.write_gap = hi

    # ---- the numbers ----
    @property
    def rows_max(self) -> int:
        """Rows of the longest stacked array (the row terms' buffer rows)."""
        return max(self.stack_len.values(), default=0)

    @property
    def shared_floats(self) -> int:
        """Floats of shared memory one block uses: the slots, the stacked
        rows, the double-buffered row terms, each ``[.][32]``."""
        return (self.n_slots + self.stack_rows + 2 * self.rows_max) * LANES

    def replicated_ops(self) -> int:
        """Operations the streams perform beyond the one-thread program:
        every replicated statement and every row sum's adds, done by W
        warps instead of one (each counted W - 1 times)."""
        extra = 0

        def rloop(nodes, trips):
            nonlocal extra
            for n in nodes:
                if not self.is_live(n):
                    continue
                if isinstance(n, cgen.Val):
                    extra += trips * cgen.expr_ops(n.expr)
                elif isinstance(n, cgen.Dphi):
                    extra += trips * n.n
                elif isinstance(n, cgen.Loop):
                    rloop(n.body, trips * n.n)

        def region(reg, trips):
            nonlocal extra
            for st in reg.stages:
                for sy in st.syncs:
                    if sy.what == "dphi":
                        extra += trips * sy.node.n
                    elif sy.what == "rloop":
                        rloop(sy.node.body, trips * sy.node.n)
                    else:
                        region(sy.body, trips * sy.node.n)
                for w, item in st.entries:
                    if w == REPL and item[0] == "val":
                        extra += trips * cgen.expr_ops(item[1].expr)

        region(self.regions[0], 1)
        return extra * (self.W - 1)

    def rows(self, n: int, w: int) -> Tuple[int, int]:
        """Warp ``w``'s range of a row sum's ``n`` rows."""
        return n * w // self.W, n * (w + 1) // self.W


def _scan_slots(intervals, info) -> int:
    """Give each (start, end, name) interval, sorted by start, a slot free
    over [start, end] (the lowest one); returns the slots used."""
    free: List[int] = []
    active: List[Tuple[int, int]] = []  # (end, slot)
    top = 0
    for s, e, a in intervals:
        while active and active[0][0] < s:
            heapq.heappush(free, heapq.heappop(active)[1])
        slot = heapq.heappop(free) if free else top
        top = max(top, slot + 1)
        info[a].slot = slot
        heapq.heappush(active, (e, slot))
    return top


def _scan_rows(intervals, info, length: Dict[str, int]) -> int:
    """``_scan_slots`` for stacked arrays: a first-fit run of ``length[name]``
    rows each; returns the rows used."""
    busy: List[int] = []  # the end epoch of each row's last occupant
    for s, e, a in intervals:
        n, i = length[a], 0
        while not all(i + j >= len(busy) or busy[i + j] < s for j in range(n)):
            i += 1
        busy.extend([-1] * (i + n - len(busy)))
        busy[i : i + n] = [e] * n
        info[a].slot = i
    return len(busy)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


class _Writer:
    """Warp ``w``'s stream of a schedule as C lines."""

    def __init__(self, sch: Schedule, w: int, sum_unroll: int = SUM_UNROLL):
        self.sch, self.w = sch, w
        self.sum_unroll = sum_unroll
        self.lines: List[str] = []
        self.depth = 2
        self.loops = 0

    def line(self, text: str):
        self.lines.append("  " * self.depth + text)

    def ref(self, a: str) -> str:
        """How warp w reads ``a``: its register, a shared slot, the input
        row, or the literal itself."""
        inf = self.sch.info.get(a)
        if inf is None:
            return a
        if inf.owner == INLINE:
            n = self.sch.loads[a]
            return f"{n.ptr}[{n.row} * B + bl]"
        if inf.owner == REPL or inf.owner == self.w:
            return a
        x = f"SH({inf.slot})"
        return {"f": x, "b": f"team_bool({x})", "i": f"team_int({x})"}[inf.kind]

    def write_slot(self, a: str, value: str):
        inf = self.sch.info[a]
        x = {"f": value, "b": f"{value} ? 1.0f : 0.0f", "i": f"(float){value}"}[inf.kind]
        self.line(f"SH({inf.slot}) = {x};")

    def val(self, n: cgen.Val):
        if isinstance(n, cgen.ArrLoad):
            self.line(f"const float {n.name} = SCR({self.sch.arr_base[n.arr]} + {n.index});")
            return
        expr = n.template.format(*[self.ref(a) for a in n.args])
        if isinstance(n, cgen.DynLoad):  # lanes past B read env B - 1
            expr = expr.replace(" * B + b]", " * B + bl]")
        self.line(f"const {cgen._CTYPE[n.kind]} {n.name} = {expr};")

    def bar(self):
        self.line("TEAM_BAR();")

    def open_loop(self, n: int, lo: int = 0, var: Optional[str] = None,
                  unroll: int = 0) -> str:
        self.loops += 1
        var = var or f"ti{self.loops}"
        if unroll:
            self.line("TEAM_PRAGMA(unroll)" if unroll < 0 else f"TEAM_PRAGMA(unroll {unroll})")
        self.line(f"for (int {var} = {lo}; {var} < {n}; ++{var}) {{")
        self.depth += 1
        return var

    def close(self):
        self.depth -= 1
        self.line("}")

    def dphi(self, n: cgen.Dphi):
        """Terms of this warp's rows into the shared terms buffer, a barrier,
        then the in-order sum of all rows (``CProgram.os_dphi``'s order)."""
        if n.D in self.sch.arr_base:
            return self.dphi_scratch(n)
        base = {a: f"TEAM_STACK0 + {self.sch.info[a].slot}" for a in (n.D, n.jar, n.jv)}
        alpha = self.ref(n.alpha)
        d = n.name
        self.line(f"const int {d}_b = tb; tb ^= 1;")
        r0, r1 = self.sch.rows(n.n, self.w)
        r = self.open_loop(r1, r0, f"{d}_r")
        self.line(f"const float {d}_m = {alpha} * SH({base[n.jv]} + {r});")
        self.line(f"const float {d}_j = SH({base[n.jar]} + {r}) + {d}_m;")
        self.line(f"const float {d}_d = SH({base[n.D]} + {r}) * {d}_j;")
        self.line(f"const float {d}_t = pmin({d}_d, 0.0f);")
        self.line(f"const float {d}_p = {d}_t * SH({base[n.jv]} + {r});")
        self.line(f"TEAM_TERM({d}_b, {r}) = {d}_p;")
        self.close()
        self.bar()
        self.line(f"float {d} = 0.0f;")
        r = self.open_loop(n.n, 0, f"{d}_r", self.sum_unroll)
        self.line(f"{d} = {d} + TEAM_TERM({d}_b, {r});")
        self.close()

    def dphi_scratch(self, n: cgen.Dphi):
        """``dphi`` over stacked rows in the scratch (indexed arrays): the
        terms go to the scratch's double-buffered term rows."""
        base = {a: self.sch.arr_base[a] for a in (n.D, n.jar, n.jv)}
        alpha, d, t0 = self.ref(n.alpha), n.name, self.sch.term_base
        self.line(f"const int {d}_b = tb; tb ^= 1;")
        r0, r1 = self.sch.rows(n.n, self.w)
        r = self.open_loop(r1, r0, f"{d}_r")
        self.line(f"const float {d}_m = {alpha} * SCR({base[n.jv]} + {r});")
        self.line(f"const float {d}_j = SCR({base[n.jar]} + {r}) + {d}_m;")
        self.line(f"const float {d}_d = SCR({base[n.D]} + {r}) * {d}_j;")
        self.line(f"const float {d}_t = pmin({d}_d, 0.0f);")
        self.line(f"const float {d}_p = {d}_t * SCR({base[n.jv]} + {r});")
        self.line(f"SCR({t0} + {d}_b * {n.n} + {r}) = {d}_p;")
        self.close()
        self.bar()
        self.line(f"float {d} = 0.0f;")
        r = self.open_loop(n.n, 0, f"{d}_r", self.sum_unroll)
        self.line(f"{d} = {d} + SCR({t0} + {d}_b * {n.n} + {r});")
        self.close()

    def rloop(self, loop: cgen.Loop):
        """A loop run whole by every warp, its carries in registers."""
        live = [j for j, (c, _, _) in enumerate(loop.carries) if c in self.sch.live]
        for j in live:
            c, kind, init = loop.carries[j]
            self.line(f"{cgen._CTYPE[kind]} {c} = {self.ref(init)};")
        self.open_loop(loop.n, var=loop.var)
        for n in loop.body:
            if not self.sch.is_live(n):
                continue
            if isinstance(n, cgen.Val):
                self.val(n)
            elif isinstance(n, cgen.Dphi):
                self.dphi(n)
            else:
                self.rloop(n)
        for j in live:
            self.line(f"{loop.carries[j][0]} = {loop.new[j]};")
        self.close()

    def ploop(self, sy: _Sync):
        """A partitioned loop: carries in shared slots, written by their
        owners before the loop and between two barriers after each trip."""
        loop, live = sy.node, [j for j, (c, _, _) in enumerate(sy.node.carries)
                               if c in self.sch.live]
        for j in live:
            if sy.init_writers[j] == self.w:
                self.write_slot(loop.carries[j][0], self.ref(loop.carries[j][2]))
        self.bar()
        self.open_loop(loop.n, var=loop.var)
        self.region(sy.body)
        self.bar()
        for j in live:
            if sy.new_writers[j] == self.w:
                self.write_slot(loop.carries[j][0], self.ref(loop.new[j]))
        self.bar()
        self.close()

    def region(self, reg: _Region):
        w, sch = self.w, self.sch
        for k, st in enumerate(reg.stages):
            if k:
                self.bar()
            for sy in st.syncs:
                if sy.what == "dphi":
                    self.dphi(sy.node)
                elif sy.what == "rloop":
                    self.rloop(sy.node)
                else:
                    self.ploop(sy)
            for ew, item in st.entries:
                if ew != w and ew != REPL:
                    continue
                if item[0] == "val":
                    self.val(item[1])
                elif item[0] == "store":
                    n = item[1]
                    self.line(f"if (live) {n.ptr}[{n.row} * B + b] = {self.ref(n.arg)};")
                elif item[0] == "astore":
                    n = item[1]
                    self.line(f"SCR({sch.arr_base[n.arr]} + {n.index}) = {self.ref(n.arg)};")
                else:
                    _, stack, row, a = item
                    self.line(f"SH(TEAM_STACK0 + {sch.info[stack].slot + row}) = {self.ref(a)};")
            for a in sch.slot_writes.get((reg.rid, k), ()):
                if sch.info[a].owner == w:
                    self.write_slot(a, a)


def render_streams(sch: Schedule, sum_unroll: int = SUM_UNROLL) -> List[List[str]]:
    """Each warp's stream as C lines (the body of its ``case``)."""
    out = []
    for w in range(sch.W):
        wr = _Writer(sch, w, sum_unroll)
        wr.region(sch.regions[0])
        out.append(wr.lines)
    return out


_TRIPS = re.compile(r"for \(int \w+ = (\d+); \w+ < (\d+); \+\+\w+\) \{$")
_SHARED_READ = re.compile(r"\b(?:SH|TEAM_TERM|SCR)\([^()]*\)|\w+\[[^\]]*\]")
_STMT = re.compile(r"(?:const )?(?:float|bool|int) \w+ = (.*);$|(\w+) = \2 \+ (.*);$")


def _trip_lines(lines: List[str]):
    """Each statement line of a rendered stream, stripped, with the trips
    of the loops around it."""
    trips = [1]
    for line in lines:
        line = line.strip()
        m = _TRIPS.match(line)
        if m:
            trips.append(trips[-1] * (int(m.group(2)) - int(m.group(1))))
        elif line == "}":
            trips.pop()
        else:
            yield trips[-1], line


def stream_ops(lines: List[str]) -> int:
    """Float operations one rendered stream performs for one env: the
    operators of every statement (and of every row sum's adds), each
    weighted by the trips of the loops around it, counted as
    ``cgen.op_count`` counts the one-thread body. Shared-memory and input
    reads are operands, not work."""
    total = 0
    for trips, line in _trip_lines(lines):
        m = _STMT.match(line)
        if m:
            rhs = m.group(1) if m.group(1) is not None else f"x + {m.group(3)}"
            rhs = _SHARED_READ.sub("x", rhs)
            rhs = re.sub(r"\bteam_(?:bool|int)\(x\)", "x", rhs)
            total += trips * cgen.expr_ops(rhs)
    return total


def stream_barriers(lines: List[str]) -> int:
    """Barriers one rendered stream passes for one env (loop trips counted)."""
    return sum(trips for trips, line in _trip_lines(lines) if line == "TEAM_BAR();")


_INPUT_READ = re.compile(r"\b\w+\[\d+ \* B \+ bl\]")
_SLOT = re.compile(r"\b(?:SH|TEAM_TERM)\(")


def stream_traffic(lines: List[str]) -> Dict[str, int]:
    """The memory traffic of one rendered stream for one env, loop trips
    counted: ``loads`` (input rows read from global memory, each use a
    read), ``stores`` (output rows written), ``shared_writes`` and
    ``shared_reads`` (slots, stacked rows and row terms)."""
    out = dict(loads=0, stores=0, shared_writes=0, shared_reads=0)
    for trips, line in _trip_lines(lines):
        if line.startswith("if (live) "):
            out["stores"] += trips
            line = line.split(" = ", 1)[1]
        elif _SLOT.match(line):
            out["shared_writes"] += trips
            line = line.split(" = ", 1)[1]
        out["loads"] += trips * len(_INPUT_READ.findall(line))
        out["shared_reads"] += trips * len(_SLOT.findall(line))
    return out


def render(sch: Schedule, name: str, params: str, what: str, base_ops: int,
           sum_unroll: int = SUM_UNROLL, preamble: str = "") -> Tuple[str, dict]:
    """The team body: one ``PUPPAX_HD`` function whose ``switch (warp)``
    holds each warp's stream in its own ``case``, after the ``#define``s the
    shell reads (``TEAM_W``, the shared memory layout) and the program's
    ``preamble`` (``cgen.CProgram.preamble``: its constant grid). Returns (source,
    stats): the one-thread program's operations, each stream's, the
    replicated ones, the barriers and the shared bytes."""
    streams = render_streams(sch, sum_unroll)
    ops = [stream_ops(s) for s in streams]
    stats = dict(
        warps=sch.W, ops_per_env=base_ops, stream_ops=ops, replicated_ops=sch.replicated_ops(),
        barriers=stream_barriers(streams[0]), stages=[len(r.stages) for r in sch.regions],
        slots=sch.n_slots, shared_bytes=4 * sch.shared_floats, write_gap=sch.write_gap,
    )
    scratch, scr_param = "", ""
    if sch.scratch_rows:  # a box model's arrays, in a global scratch
        stats["scratch_bytes_per_env"] = 4 * sch.scratch_rows
        scratch = (f"// Its indexed arrays: {4 * sch.scratch_rows} bytes of global scratch per "
                   f"env.\n#define TEAM_SCRATCH_ROWS {sch.scratch_rows}\n")
        scr_param = ", float* scr"
    head = (
        f"// Generated by puppax_torch/kernels/team.py from the {what},\n"
        f"// split across {sch.W} warps: {base_ops} operations per env in one thread,\n"
        f"// the heaviest stream {max(ops)}, {stats['replicated_ops']} replicated in all,\n"
        f"// {stats['barriers']} barriers, {stats['shared_bytes']} bytes of shared memory.\n"
        f"{scratch}"
        f"// Do not edit.\n"
        f"#define TEAM_W {sch.W}\n"
        f"#define TEAM_STACK0 {sch.n_slots}\n"
        f"#define TEAM_TERMS {sch.n_slots + sch.stack_rows}\n"
        f"#define TEAM_TERM_ROWS {max(sch.rows_max, 1)}\n"
        f"#define TEAM_SHARED_FLOATS {sch.shared_floats}\n"
        + preamble
        + f"TEAM_FN inline void {name}({params}, int B, int b, int warp, int lane,\n"
        f"    float* sh{scr_param} TEAM_BAR_PARAM) {{\n"
        "  const int bl = b < B ? b : B - 1;  // lanes past B compute env B - 1, store nothing\n"
        "  const bool live = b < B;\n"
        "  int tb = 0;  // the row terms' buffer\n"
        "  (void)bl; (void)live; (void)tb;\n"
        "  switch (warp) {\n"
    )
    cases = "".join(
        f"  case {w}: {{\n" + "\n".join(lines) + "\n  } break;\n" for w, lines in enumerate(streams)
    )
    return head + cases + "  }\n}\n", stats


def team_body(prog: cgen.CProgram, warps: int, name: str, params: str, what: str,
              cap: int = CAP, cross: float = CROSS, shared_budget: int = SHARED_BUDGET,
              sum_unroll: int = SUM_UNROLL,
              loop_weight: int = REPLICATED_LOOP_WEIGHT) -> Tuple[str, dict]:
    """Schedule ``prog`` across ``warps`` warps and render it (a loop whose
    body weighs no more than ``loop_weight`` runs whole in every warp)."""
    base_ops = cgen.op_count("\n".join(prog.lines))
    return render(Schedule(prog, warps, cap, cross, shared_budget, loop_weight), name, params,
                  what, base_ops, sum_unroll, prog.preamble())


def physics_step_team_body(s, n_substeps: int, warps: int, phase_limit=None,
                           sink: bool = False, loop_weight: int = REPLICATED_LOOP_WEIGHT,
                           cap: int = CAP) -> Tuple[str, dict]:
    """Team K1: ``cgen.physics_step_program`` as ``physics_step_team_body``
    (shell ``csrc/physics_step_team.cuh``). ``phase_limit`` and ``sink``
    give the team probes' program (``cgen.physics_step_body``'s cut and
    sink row), rendered under ``PP_PARAMS`` for ``csrc/probe_physics_team.cuh``;
    the schedule's knobs are production's unless a probe passes
    ``loop_weight`` (below the substep loop's weight, the loop is
    partitioned) or ``cap``."""
    cut = "" if phase_limit is None else f", cut after phase {phase_limit}"
    return team_body(cgen.physics_step_program(s, n_substeps, phase_limit, sink), warps,
                     "physics_step_team_body", "PP_PARAMS" if sink else "PS_PARAMS",
                     f"physics-step emission (n_substeps={n_substeps}{cut}"
                     f"{', sink row' if sink else ''})", cap=cap, loop_weight=loop_weight)


def env_step_team_body(s, es, n_substeps: int, warps: int) -> Tuple[str, dict]:
    """Team K2: ``cgen.env_step_program`` as ``env_step_team_body`` (shell
    ``csrc/env_step_team.cuh``)."""
    return team_body(cgen.env_step_program(s, es, n_substeps), warps,
                     "env_step_team_body", "ES_PARAMS",
                     f"env-step emission (n_substeps={n_substeps})")


def wrapped_step_team_body(s, es, n_substeps: int, episode_length: int,
                           warps: int) -> Tuple[str, dict]:
    """K3's program (``cgen.wrapped_step_program``) as
    ``wrapped_step_team_body``, which team K4 (``csrc/fused_unroll_team.cuh``)
    runs once per step."""
    return team_body(cgen.wrapped_step_program(s, es, n_substeps, episode_length), warps,
                     "wrapped_step_team_body", "WS_PARAMS",
                     f"wrapped-step emission (n_substeps={n_substeps}, "
                     f"episode_length={episode_length})")
