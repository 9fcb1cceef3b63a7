"""The physics emitter: one straight-line per-env program, two back-ends.

Counterpart of ``puppax/physics/soa.py``. There a trace-time value algebra
(constant folding in f64 + hash-consing CSE) emits the per-env physics
program (FK, COM, CRB mass matrix, RNE, PD actuation, tree-sparse LDL^T,
uncapped narrowphase, solref/solimp rows, one Newton step with an Illinois
exact line search, semi-implicit Euler) and Pallas lowers it over (8, 128)
tiles. Here the SAME algebra and the same emitters are written against a
small back-end interface, so one emission has two back-ends:

* torch rows (the plain version): every value is a ``(B,)`` float32
  tensor, every op a torch op, a loop a Python loop;
* CUDA C source (``puppax_torch/kernels/cgen.py``): every value is a named
  C scalar, every op one SSA line, a loop a C ``for``.

Values are Python floats (trace-time constants, folded in f64 and rounded
to f32 where they meet a tensor, as JAX's weak typing does) or back-end
values. The back-end ops below (``where``, ``maximum``, ``clip``, ...)
dispatch on their operands: a torch tensor runs the torch op; any other
value carries its back-end as ``._bk``.

The supported class is a free+hinge tree with plane-sphere, sphere-sphere,
world-static sphere-box and world-static hfield-sphere contacts
(``soa_supported``). The hfield pair's four corner elevations come from one
more back-end op, ``grid_at``: a lookup into the model's constant grid at
the footprint's cell (the JAX emission folds one-hot masks over the whole
grid instead, a TPU device that picks the same values).

The sphere-box pairs (obstacle terrain) are emitted as loops over a
constant table of the boxes (``_Boxes``), not pair by pair as the JAX
emission unrolls them, so the program does not grow with the number of
boxes: one trip computes, for every sphere in turn, what one pair computes
(``_emit_sphere_box``, ``_pair_rows``), with the box's rotation, position
and half-sizes read at the trip index (``table_at``) and the pair's DR row
likewise (``row_at``). What a later stage needs of the box rows goes
through indexed row arrays (``new_array``, ``array_store``,
``array_load``). The rows keep the JAX emission's order, box by box and
sphere by sphere, so every in-order sum adds the same terms in the same
order; the table's exact 0 and 1 entries, which JAX folds away, give the
same values up to the sign of a zero. Every kernel built from this
emission takes a box model: K1, K2, K3 and K4, one-thread and team (the
team bodies keep the arrays in a global scratch, ``kernels/team.py``), so
such a model trains on every lane. The capsule kinds (plane-capsule, two
pairs a pair, one per capsule end; sphere-capsule; capsule-capsule) are
straight-line code pair by pair, as the JAX emission emits them
(``_emit_plane_capsule``, ``_emit_sphere_capsule``,
``_emit_capsule_capsule``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from puppax_torch.kernels import build
from puppax_torch.model.mjcf import JNT_FREE, JNT_HINGE, MjTables, RobotModel

_MINVAL = 1e-15
_PAD_DIST = 1e10  # collision._PAD_DIST: a footprint outside the heightfield

# the largest heightfield grid the emitter takes (puppax/physics/soa.py's
# bound; here the grid is a table the kernel reads, 4 bytes a cell)
MAX_HFIELD_CELLS = 4096

# Line-search trip counts of the Illinois regula falsi in _emit_newton.
# Lowering them broke kernel parity in the JAX package; they stay fixed.
LS_EXPAND_ITERS = 12
LS_ILLINOIS_ITERS = 24

# The cuts of the forward pass the kernel-time probes build (the values of
# puppax/physics/soa.py's PHASE_LIMIT, in program order): after the
# kinematics and the subtree COM, the COM-frame inertias and dof axes, the
# COM velocities, the CRB mass matrix, the RNE bias forces, the smooth
# acceleration, and the contact / friction / limit rows; None is the whole
# pass.
PHASES = ("fk", "compos", "comvel", "crb", "rne", "smooth", "efc", None)


# ---------------------------------------------------------------------------
# value algebra with constant folding and CSE
# ---------------------------------------------------------------------------


def _c(x) -> bool:
    return isinstance(x, (int, float))


# Inside a ``cse_scope`` the algebra memoizes every emitted op on the
# identity of its operands. The memo keeps strong references to operands so
# id() values cannot be recycled while they serve as keys. Loop bodies push
# a fresh scope so no value born inside a loop is reused after it.
_CSE_MEMO = None


class cse_scope:
    """Hash-consing for emissions inside it. ``fresh=False`` joins an
    active scope; ``fresh=True`` always pushes a new memo (loop bodies)."""

    def __init__(self, fresh: bool = False):
        self._fresh = fresh

    def __enter__(self):
        global _CSE_MEMO
        self._prev = _CSE_MEMO
        if self._fresh or _CSE_MEMO is None:
            _CSE_MEMO = {}
        return self

    def __exit__(self, *exc):
        global _CSE_MEMO
        _CSE_MEMO = self._prev
        return False


def with_cse(fn):
    """Decorator: run ``fn`` inside a (joining) cse_scope."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with cse_scope():
            return fn(*args, **kwargs)

    return wrapped


def _ckey(x):
    return ("c", x) if _c(x) else ("t", id(x))


def _cse2(op: str, a, b, emit):
    memo = _CSE_MEMO
    if memo is None:
        return emit()
    ka, kb = _ckey(a), _ckey(b)
    if op in ("add", "mul") and kb < ka:  # commutative: canonical order
        ka, kb = kb, ka
    key = (op, ka, kb)
    hit = memo.get(key)
    if hit is not None:
        return hit[2]
    res = emit()
    memo[key] = (a, b, res)
    return res


def add(a, b):
    if _c(a) and _c(b):
        return a + b
    if _c(a) and a == 0.0:
        return b
    if _c(b) and b == 0.0:
        return a
    return _cse2("add", a, b, lambda: a + b)


def sub(a, b):
    if _c(a) and _c(b):
        return a - b
    if _c(b) and b == 0.0:
        return a
    if _c(a) and a == 0.0:
        return neg(b)
    return _cse2("sub", a, b, lambda: a - b)


def neg(a):
    if _c(a):
        return -a
    return _cse2("neg", a, a, lambda: -a)


def mul(a, b):
    if _c(a) and _c(b):
        return a * b
    if _c(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return neg(b)
        return _cse2("mul", a, b, lambda: a * b)
    if _c(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return neg(a)
    return _cse2("mul", a, b, lambda: a * b)


def fma(acc, a, b):
    """acc + a*b with folding (two rounded ops, never a fused one)."""
    return add(acc, mul(a, b))


def vadd3(a, b):
    return [add(a[i], b[i]) for i in range(3)]


def vsub3(a, b):
    return [sub(a[i], b[i]) for i in range(3)]


def vscale3(a, s):
    return [mul(a[i], s) for i in range(3)]


def vdot3(a, b):
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]))


def vcross3(a, b):
    return [
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    ]


def qmul(u, v):
    """Hamilton product on (w,x,y,z) component lists (ops.math.quat_mul)."""
    return [
        sub(sub(sub(mul(u[0], v[0]), mul(u[1], v[1])), mul(u[2], v[2])), mul(u[3], v[3])),
        sub(add(add(mul(u[0], v[1]), mul(u[1], v[0])), mul(u[2], v[3])), mul(u[3], v[2])),
        add(add(sub(mul(u[0], v[2]), mul(u[1], v[3])), mul(u[2], v[0])), mul(u[3], v[1])),
        add(sub(add(mul(u[0], v[3]), mul(u[1], v[2])), mul(u[2], v[1])), mul(u[3], v[0])),
    ]


def qrot(vec, q):
    """rotate(vec, q) — same formula as ops.math.rotate."""
    s, u = q[0], q[1:]
    uv = vdot3(u, vec)
    uu = vdot3(u, u)
    k = sub(mul(s, s), uu)
    c = vcross3(u, vec)
    return [
        add(add(mul(mul(2.0, uv), u[i]), mul(k, vec[i])), mul(mul(2.0, s), c[i]))
        for i in range(3)
    ]


def quat_to_mat(q):
    """3x3 rotation matrix rows (list of 3 row lists), ops.math.quat_to_mat."""
    w, x, y, z = q
    return [
        [
            sub(1.0, mul(2.0, add(mul(y, y), mul(z, z)))),
            mul(2.0, sub(mul(x, y), mul(w, z))),
            mul(2.0, add(mul(x, z), mul(w, y))),
        ],
        [
            mul(2.0, add(mul(x, y), mul(w, z))),
            sub(1.0, mul(2.0, add(mul(x, x), mul(z, z)))),
            mul(2.0, sub(mul(y, z), mul(w, x))),
        ],
        [
            mul(2.0, sub(mul(x, z), mul(w, y))),
            mul(2.0, add(mul(y, z), mul(w, x))),
            sub(1.0, mul(2.0, add(mul(x, x), mul(y, y)))),
        ],
    ]


def motion_cross(v, m):
    """ops.math.motion_cross on (ang, lin) pairs."""
    va, vl = v
    ma, ml = m
    return (vcross3(va, ma), vadd3(vcross3(va, ml), vcross3(vl, ma)))


def motion_cross_force(v, f):
    """ops.math.motion_cross_force on (ang, lin) pairs."""
    va, vl = v
    fa, fl = f
    return (vadd3(vcross3(va, fa), vcross3(vl, fl)), vcross3(va, fl))


# ---------------------------------------------------------------------------
# back-end ops: the counterparts of the jnp / lax calls of the JAX emitter
# ---------------------------------------------------------------------------


def _peer(*xs):
    """None for torch operands, else the back-end of the first non-constant."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return None
        if not _c(x):
            return x._bk
    raise TypeError("back-end op on trace-time constants only")


def materialize(x, ref):
    """Constant -> a value of ref's back-end (and batch); values pass."""
    if not _c(x):
        return x
    if isinstance(ref, torch.Tensor):
        return torch.full_like(ref, float(x))
    return ref._bk.const(x)


def where(c, a, b):
    bk = _peer(c, a, b)
    if bk is None:
        return torch.where(c, a, b)
    return bk.where(c, a, b)


def _t_max(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp_min(a, b)
    return torch.clamp_min(b, a)


def _t_min(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp_max(a, b)
    return torch.clamp_max(b, a)


def maximum(a, b):
    bk = _peer(a, b)
    return _t_max(a, b) if bk is None else bk.maximum(a, b)


def minimum(a, b):
    bk = _peer(a, b)
    return _t_min(a, b) if bk is None else bk.minimum(a, b)


def clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi); bounds may be values."""
    bk = _peer(x, lo, hi)
    if bk is None:
        return _t_min(_t_max(x, lo), hi)
    return bk.minimum(bk.maximum(x, lo), hi)


def _unary(tfn, name):
    def op(x):
        bk = _peer(x)
        return tfn(x) if bk is None else bk.unary(name, x)

    op.__name__ = name
    return op


abs_ = _unary(torch.abs, "abs")
sign = _unary(torch.sign, "sign")
sqrt = _unary(torch.sqrt, "sqrt")
# 1 / sqrt(x) with both steps correctly rounded, as the C back-end emits it
# (torch.rsqrt on CUDA is the approximate hardware rsqrt)
rsqrt = _unary(lambda x: torch.sqrt(x).reciprocal(), "rsqrt")
exp = _unary(torch.exp, "exp")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
floor = _unary(torch.floor, "floor")


@functools.lru_cache(maxsize=16)
def _grid_tensor(grid: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(grid, dtype=torch.float32, device=device)


def grid_at(grid: tuple, iv, iu, dv: int = 0, du: int = 0):
    """``grid[iv + dv][iu + du]`` as float32: a lookup into a constant
    (nrow, ncol) grid (tuple rows of Python floats, each rounded to float32)
    at the whole-number values ``iv`` in [0, nrow - 2] and ``iu`` in
    [0, ncol - 2]. The indices are clipped to that range as integers, so a
    NaN index reads a cell all the same."""
    bk = _peer(iv, iu)
    if bk is not None:
        return bk.grid_at(grid, iv, iu, dv, du)
    g = _grid_tensor(grid, iv.device)
    rows = iv.long().clamp(0, len(grid) - 2) + dv
    cols = iu.long().clamp(0, len(grid[0]) - 2) + du
    return g[rows, cols]


def div_const(x, c: float):
    """x / c for a value x and a constant c, a true division in both
    back-ends (PyTorch's CUDA kernels turn a tensor divided by a Python
    scalar into a product with its reciprocal, which rounds differently)."""
    if isinstance(x, torch.Tensor):
        return x / torch.full_like(x, float(c))
    return x / c


def pow_const(x, p: float):
    """``jnp.power(x, p)`` for a value x and a constant exponent p: the math
    library's pow of two floats in both back-ends (torch ``pow`` of two
    tensors, whose scalar form would turn some exponents into products; C
    ``powf``)."""
    bk = _peer(x)
    if bk is None:
        return torch.pow(x, torch.full_like(x, float(p)))
    return bk.pow_const(x, float(p))


def full_like(ref, value: float):
    bk = _peer(ref)
    return torch.full_like(ref, float(value)) if bk is None else bk.const(value)


def int_zeros_like(ref):
    bk = _peer(ref)
    if bk is None:
        return torch.zeros_like(ref, dtype=torch.int32)
    return bk.int_const(0)


def stack_rows(values: List, ref):
    """Stack per-env values into one (n, ...) array of the line search."""
    vals = [materialize(x, ref) for x in values]
    bk = _peer(ref)
    return torch.stack(vals) if bk is None else bk.stack(vals)


def os_dphi(D_os, jar_os, jv_os, alpha):
    """sum_r min(D_r (jar_r + alpha jv_r), 0) jv_r over the stacked
    one-sided rows (the jnp.sum of the JAX line search)."""
    if isinstance(alpha, torch.Tensor):
        jar_a = jar_os + alpha[None] * jv_os
        terms = torch.clamp_max(D_os * jar_a, 0.0) * jv_os
        # summed row after row, in the C back-end's order (a torch.sum on
        # CUDA reduces in a tree and rounds differently)
        acc = terms[0]
        for r in range(1, terms.shape[0]):
            acc = acc + terms[r]
        return acc
    return alpha._bk.os_dphi(D_os, jar_os, jv_os, alpha)


def fori_loop(n: int, body, carry: List, ref=None, split: bool = False):
    """lax.fori_loop over a flat list of carried values. The body runs in
    a fresh CSE scope (a Python loop for torch, a C ``for`` for C) and
    gets the trip index: an int for torch, the C loop variable for C.
    ``split`` marks a loop over the box table, which the team renderer
    partitions across the warps whatever its weight; ``ref`` gives the
    back-end of a loop without carries."""
    bk = _peer(*carry, *([] if ref is None else [ref]))
    if bk is None:
        for i in range(n):
            with cse_scope(fresh=True):
                carry = list(body(i, carry))
        return carry
    return bk.fori_loop(n, body, carry, split=split)


def table_at(table: tuple, k, j: int, ref):
    """``table[k][j]`` as float32, a lookup into a constant table (rows of
    Python floats) at the loop index ``k``; a value of ``ref``'s back-end
    (never a trace-time constant, so nothing folds away)."""
    bk = _peer(ref)
    if bk is None:
        return torch.full_like(ref, float(table[k][j]))
    return bk.table_at(table, k, j)


def row_at(values: List, k, stride: int, j: int, n: int):
    """``values[j + k * stride]`` at the loop index ``k`` in [0, n): the
    input rows ``values`` (for C, rows of one input block whose row numbers
    step by ``stride``) read at the trip's row."""
    if isinstance(k, int):
        return values[j + k * stride]
    return k._bk.row_at(values, k, stride, j, n)


def new_array(n: int, ref):
    """An indexed array of ``n`` per-env rows (a list for torch, a local
    array for C); written and read at constant or loop-index offsets."""
    bk = _peer(ref)
    return [None] * n if bk is None else bk.array(n)


def array_store(arr, x, j: int, k=None, stride: int = 0):
    """``arr[j + k * stride] = x`` (``k`` None: ``arr[j]``)."""
    if isinstance(arr, list):
        arr[j + (k or 0) * stride] = x
    else:
        arr._bk.array_store(arr, x, j, k, stride)


def array_load(arr, j: int, k=None, stride: int = 0):
    """``arr[j + k * stride]`` (``k`` None: ``arr[j]``)."""
    if isinstance(arr, list):
        return arr[j + (k or 0) * stride]
    return arr._bk.array_load(arr, j, k, stride)


def array_rows(arr, ref):
    """The whole array as the line search's stacked rows (``os_dphi``)."""
    if isinstance(arr, list):
        return torch.stack([materialize(x, ref) for x in arr])
    return arr


# ---------------------------------------------------------------------------
# static model digest (host-side numpy)
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    # 'ps' (plane-sphere), 'ss' (sphere-sphere), 'bs' (sphere-box), 'hs'
    # (hfield-sphere), 'pc' (plane-capsule, one pair per capsule end), 'sc'
    # (sphere-capsule) or 'cc' (capsule-capsule)
    kind: str
    sphere_geom: int
    sphere_body: int
    radius: float
    sphere_off: tuple
    plane_point: tuple
    plane_n: tuple
    frame_t1: tuple
    frame_t2: tuple
    solref: tuple
    solimp: tuple
    invweight: float
    geom1: int
    geom2: int
    body1: int
    body2: int
    radius1: float = 0.0
    sphere_off1: tuple = (0.0, 0.0, 0.0)
    # bs only: the world-static box's rotation (rows), position and half-sizes
    box_R: tuple = ()
    box_pos: tuple = (0.0, 0.0, 0.0)
    box_half: tuple = (0.0, 0.0, 0.0)
    # hs only: the world-static heightfield's rotation (rows), position,
    # (rx, ry, elevation z) and grid (rows of floats, row 0 at y = -ry)
    hf_R: tuple = ()
    hf_pos: tuple = (0.0, 0.0, 0.0)
    hf_size: tuple = (0.0, 0.0, 0.0)
    hf_grid: tuple = ()
    # pc, sc, cc: the geom2-side capsule's half-length and local quaternion;
    # pc: its end (0 at -axis, 1 at +axis); cc: the geom1-side capsule's
    # (its center and radius in sphere_off1 / radius1)
    cap_half: float = 0.0
    cap_quat: tuple = (1.0, 0.0, 0.0, 0.0)
    cap_end: int = 0
    cap_half1: float = 0.0
    cap_quat1: tuple = (1.0, 0.0, 0.0, 0.0)


class _Boxes(NamedTuple):
    """The sphere-box pairs as one loop over the boxes: pairs ``first`` to
    ``first + n * len(spheres) - 1`` of ``_Static.pairs``, box by box, each
    box's pairs one per sphere in the order of ``spheres`` (box 0's pairs),
    and per box its table row: the rotation's rows (9), position (3) and
    half-sizes (3), then, when the boxes' pairs differ in their contact
    parameters (``params``), each sphere's ``N_CONTACT_CONSTANTS`` constants
    of its pair with the box (``_contact_constants``)."""

    first: int
    n: int
    spheres: tuple
    table: tuple
    params: bool = False


# a pair's contact constants, in a box table's per-sphere columns: the
# stiffness and damping (_kb), the friction rows' R factor, and the
# impedance's (_impedance_constants)
N_CONTACT_CONSTANTS = 9
BOX_POSE_COLUMNS = 15


def _contact_constants(pr: "_Pair", impratio: float) -> tuple:
    """The constants ``_pair_rows`` folds into a pair's rows, as Python
    floats in the order of ``N_CONTACT_CONSTANTS``."""
    return (*_kb(pr.solref, pr.solimp), pr.invweight * 2.0 / impratio,
            *_impedance_constants(pr.solimp))


def _box_major(pairs) -> bool:
    """True when the sphere-box pairs come box by box, each box paired
    with the same spheres in the same order (``tables._collision_pairs``'s
    order for world boxes)."""
    boxes = list(dict.fromkeys(b for _, b in pairs))
    spheres = [g for g, b in pairs if b == boxes[0]]
    return list(pairs) == [(g, b) for b in boxes for g in spheres]


def soa_supported(m: RobotModel) -> bool:
    """True when the model is in the emitter's supported class: one
    kinematic tree on one free joint, world-static planes (capsule pairs'
    too), world-static boxes paired box by box with the same spheres, and a
    world-static heightfield of 2 x 2 to ``MAX_HFIELD_CELLS`` cells."""
    if any(m.geom_bodyid[g1] != 0 for g1, _ in m.pairs_plane_capsule):
        return False
    if m.pairs_sphere_box:
        if any(m.geom_bodyid[g2] != 0 for _, g2 in m.pairs_sphere_box):
            return False
        if not _box_major(m.pairs_sphere_box):
            return False
    if m.pairs_hfield_sphere:
        if m.hfield_data is None or m.hfield_nrow < 2 or m.hfield_ncol < 2:
            return False
        if m.hfield_nrow * m.hfield_ncol > MAX_HFIELD_CELLS:
            return False
        for g1, _ in m.pairs_hfield_sphere:
            if m.geom_bodyid[g1] != 0:
                return False
    if m.solver_iterations != 1:
        return False
    for j in range(m.njnt):
        if m.jnt_type[j] not in (JNT_FREE, JNT_HINGE):
            return False
    for g1, _ in m.pairs_plane_sphere:
        if m.geom_bodyid[g1] != 0:
            return False
    for b in range(1, m.nbody):
        if m.body_rootid[b] != 1:
            return False
    free = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_FREE]
    if len(free) != 1 or m.jnt_bodyid[free[0]] != 1:
        return False
    return True


def _quat_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _boxes(pairs: List[_Pair], impratio: float) -> Optional[_Boxes]:
    """The sphere-box pairs of ``pairs`` as one loop over the boxes, or None
    without any. Every box's pair with a given sphere names the same sphere
    and bodies; the boxes' own poses and sizes go into the table. Where the
    boxes' pairs carry the same contact parameters, as ``obstacles.py``'s
    boxes do, the loop folds them in as constants; where they differ
    (solref, solimp or invweight; not solimp's power), each box's row also
    holds its pairs' ``_contact_constants``, read in the loop as the pose
    is."""
    idx = [i for i, p in enumerate(pairs) if p.kind == "bs"]
    if not idx:
        return None
    bs = [pairs[i] for i in idx]
    nsph = sum(1 for p in bs if p.geom2 == bs[0].geom2)
    spheres = tuple(bs[:nsph])
    same = ("sphere_geom", "sphere_body", "radius", "sphere_off", "body1", "body2")
    for i, p in enumerate(bs):
        if any(getattr(p, f) != getattr(spheres[i % nsph], f) for f in same):
            raise NotImplementedError(
                "boxes whose pairs differ in their sphere or bodies are outside the "
                "emitter's box loop")
    params = any(getattr(p, f) != getattr(spheres[i % nsph], f)
                 for i, p in enumerate(bs) for f in ("solref", "solimp", "invweight"))
    if params and any(float(p.solimp[4]) != float(spheres[i % nsph].solimp[4])
                      for i, p in enumerate(bs)):
        raise NotImplementedError("boxes whose pairs differ in solimp's power are outside "
                                  "the emitter's box loop")
    table = tuple(
        tuple(c for row in p.box_R for c in row) + tuple(p.box_pos) + tuple(p.box_half)
        + (tuple(c for q in bs[b * nsph:(b + 1) * nsph] for c in _contact_constants(q, impratio))
           if params else ())
        for b, p in enumerate(bs[::nsph]))
    return _Boxes(first=idx[0], n=len(bs) // nsph, spheres=spheres, table=table, params=params)


class _Static:
    """Everything the emission bakes in as Python constants. Numeric
    tables come from the float64 MjModel tables when given (as the JAX
    package reads them from ``mujoco.MjModel``), else from the model's
    float32 leaves."""

    def __init__(self, m: RobotModel, mj: MjTables = None):
        if not soa_supported(m):
            raise NotImplementedError(
                "model outside the emitter's class (one kinematic tree on one free joint, "
                "one solver iteration; planes must be world-static; boxes must be "
                "world-static and paired box by box with the same spheres; a heightfield "
                f"must be world-static, 2 x 2 to {MAX_HFIELD_CELLS} cells)"
            )
        self.nq, self.nv, self.nu = m.nq, m.nv, m.nu
        self.nbody, self.njnt, self.nsite = m.nbody, m.njnt, m.nsite
        self.body_parentid = m.body_parentid
        self.body_jntid = m.body_jntid
        self.jnt_type = m.jnt_type
        self.jnt_qposadr = m.jnt_qposadr
        self.jnt_dofadr = m.jnt_dofadr
        self.jnt_bodyid = m.jnt_bodyid
        self.timestep = float(m.timestep)
        self.impratio = float(m.impratio)
        self.solver_iterations = int(m.solver_iterations)
        if mj is not None:
            def g(name):
                tgt = np.shape(getattr(m, name))
                return np.asarray(getattr(mj, name), np.float64).reshape(tgt).copy()

            self.gravity = tuple(np.asarray(mj.gravity, np.float64).reshape(3))
            self.qpos0 = tuple(np.asarray(mj.qpos0, np.float64).reshape(-1))
            self.actuator_b0 = np.asarray(mj.actuator_biasprm, np.float64)[:, 0].copy()
        else:
            def g(name):
                return np.asarray(getattr(m, name), np.float64)

            self.gravity = tuple(g("gravity"))
            self.qpos0 = tuple(g("qpos0"))
            self.actuator_b0 = g("actuator_biasprm")[:, 0]
        geom_solref, geom_solimp = g("geom_solref"), g("geom_solimp")
        geom_pos, geom_quat, geom_size = g("geom_pos"), g("geom_quat"), g("geom_size")
        self.forcerange = g("actuator_forcerange")
        body_iw_tab = g("body_invweight0")
        self.body_pos = g("body_pos")
        self.body_quat = g("body_quat")
        self.body_iquat = g("body_iquat")
        self.jnt_pos = g("jnt_pos")
        self.jnt_axis = g("jnt_axis")
        self.jnt_range = g("jnt_range")
        self.jnt_solref = g("jnt_solref")
        self.jnt_solimp = g("jnt_solimp")
        self.jnt_margin = g("jnt_margin")
        self.jnt_limited = m.jnt_limited
        self.dof_armature = g("dof_armature")
        self.dof_damping = g("dof_damping")
        self.dof_frictionloss = g("dof_frictionloss")
        self.dof_solref = g("dof_solref")
        self.dof_solimp = g("dof_solimp")
        self.dof_invweight0 = g("dof_invweight0")
        self.dof_frictional = m.dof_frictional
        self.site_pos = g("site_pos")
        self.site_bodyid = m.site_bodyid
        self.actuator_jntid = m.actuator_jntid

        # ---- per-dof ancestor chains (tree sparsity) ----
        body_dofs = [[] for _ in range(m.nbody)]
        for j in range(m.njnt):
            b, d = m.jnt_bodyid[j], m.jnt_dofadr[j]
            n = 6 if m.jnt_type[j] == JNT_FREE else 1
            body_dofs[b].extend(range(d, d + n))
        chains = [[] for _ in range(m.nbody)]
        for i in range(1, m.nbody):
            chains[i] = chains[m.body_parentid[i]] + body_dofs[i]
        self.body_dofs = body_dofs
        self.chains = chains
        dof_body = [0] * m.nv
        for j in range(m.njnt):
            b, d = m.jnt_bodyid[j], m.jnt_dofadr[j]
            n = 6 if m.jnt_type[j] == JNT_FREE else 1
            for dd in range(d, d + n):
                dof_body[dd] = b
        self.dof_body = dof_body
        anc = np.zeros((m.nv, m.nv), bool)
        for jd in range(m.nv):
            for kd in chains[dof_body[jd]]:
                if kd <= jd:
                    anc[jd, kd] = True
        self.anc = anc

        # ---- collision pairs: plane-sphere (static plane), sphere-sphere ----
        body_iw = body_iw_tab[:, 0]
        self.pairs: List[_Pair] = []
        for g1, g2 in m.pairs_plane_sphere:
            R = _quat_mat_np(geom_quat[g1])
            n = R[:, 2]
            e = (
                np.array([0.0, 1.0, 0.0])
                if abs(n[1]) < 0.5
                else np.array([0.0, 0.0, 1.0])
            )
            t2 = np.cross(n, e)
            t2 = t2 / max(np.linalg.norm(t2), 1e-12)
            t1 = np.cross(t2, n)
            sb = m.geom_bodyid[g2]
            self.pairs.append(
                _Pair(
                    kind="ps",
                    sphere_geom=g2,
                    sphere_body=sb,
                    radius=float(geom_size[g2][0]),
                    sphere_off=tuple(geom_pos[g2]),
                    plane_point=tuple(geom_pos[g1]),
                    plane_n=tuple(n),
                    frame_t1=tuple(t1),
                    frame_t2=tuple(t2),
                    solref=tuple(0.5 * (geom_solref[g1] + geom_solref[g2])),
                    solimp=tuple(0.5 * (geom_solimp[g1] + geom_solimp[g2])),
                    invweight=float(body_iw[m.geom_bodyid[g1]] + body_iw[sb]),
                    geom1=int(g1),
                    geom2=int(g2),
                    body1=int(m.geom_bodyid[g1]),
                    body2=int(sb),
                )
            )
        for g1, g2 in m.pairs_sphere_sphere:
            b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
            self.pairs.append(
                _Pair(
                    kind="ss",
                    sphere_geom=g2,
                    sphere_body=b2,
                    radius=float(geom_size[g2][0]),
                    sphere_off=tuple(geom_pos[g2]),
                    plane_point=(0.0, 0.0, 0.0),
                    plane_n=(0.0, 0.0, 1.0),
                    frame_t1=(0.0, 1.0, 0.0),
                    frame_t2=(-1.0, 0.0, 0.0),
                    solref=tuple(0.5 * (geom_solref[g1] + geom_solref[g2])),
                    solimp=tuple(0.5 * (geom_solimp[g1] + geom_solimp[g2])),
                    invweight=float(body_iw[b1] + body_iw[b2]),
                    geom1=int(g1),
                    geom2=int(g2),
                    body1=int(b1),
                    body2=int(b2),
                    radius1=float(geom_size[g1][0]),
                    sphere_off1=tuple(geom_pos[g1]),
                )
            )
        # sphere-box (world-static boxes: obstacle terrain), after the
        # sphere-sphere kind in collision's order; the sphere is geom1
        for g1, g2 in m.pairs_sphere_box:
            sb = m.geom_bodyid[g1]
            self.pairs.append(
                _Pair(
                    kind="bs",
                    sphere_geom=g1,
                    sphere_body=sb,
                    radius=float(geom_size[g1][0]),
                    sphere_off=tuple(geom_pos[g1]),
                    plane_point=(0.0, 0.0, 0.0),
                    plane_n=(0.0, 0.0, 1.0),
                    frame_t1=(0.0, 1.0, 0.0),
                    frame_t2=(-1.0, 0.0, 0.0),
                    solref=tuple(0.5 * (geom_solref[g1] + geom_solref[g2])),
                    solimp=tuple(0.5 * (geom_solimp[g1] + geom_solimp[g2])),
                    invweight=float(body_iw[sb] + body_iw[m.geom_bodyid[g2]]),
                    geom1=int(g1),
                    geom2=int(g2),
                    body1=int(sb),
                    body2=int(m.geom_bodyid[g2]),
                    box_R=tuple(tuple(float(c) for c in row)
                                for row in _quat_mat_np(geom_quat[g2])),
                    box_pos=tuple(float(c) for c in geom_pos[g2]),
                    box_half=tuple(float(c) for c in geom_size[g2]),
                )
            )
        self.boxes = _boxes(self.pairs, self.impratio)
        # hfield-sphere (a world-static heightfield), after the sphere-box
        # kind in collision's order; the float64 grid when MJ tables are given
        if m.pairs_hfield_sphere:
            if mj is not None:
                hf_data = np.asarray(mj.hfield_data, np.float64).reshape(
                    m.hfield_nrow, m.hfield_ncol)
                hf_size = np.asarray(mj.hfield_size, np.float64).reshape(-1)
            else:
                hf_data = np.asarray(m.hfield_data, np.float64)
                hf_size = np.asarray(m.hfield_size, np.float64).reshape(-1)
            hf_grid = tuple(tuple(float(x) for x in row) for row in hf_data)
        for g1, g2 in m.pairs_hfield_sphere:
            sb = m.geom_bodyid[g2]
            self.pairs.append(
                _Pair(
                    kind="hs",
                    sphere_geom=g2,
                    sphere_body=sb,
                    radius=float(geom_size[g2][0]),
                    sphere_off=tuple(geom_pos[g2]),
                    plane_point=(0.0, 0.0, 0.0),
                    plane_n=(0.0, 0.0, 1.0),
                    frame_t1=(0.0, 1.0, 0.0),
                    frame_t2=(-1.0, 0.0, 0.0),
                    solref=tuple(0.5 * (geom_solref[g1] + geom_solref[g2])),
                    solimp=tuple(0.5 * (geom_solimp[g1] + geom_solimp[g2])),
                    invweight=float(body_iw[m.geom_bodyid[g1]] + body_iw[sb]),
                    geom1=int(g1),
                    geom2=int(g2),
                    body1=int(m.geom_bodyid[g1]),
                    body2=int(sb),
                    hf_R=tuple(tuple(float(c) for c in row)
                               for row in _quat_mat_np(geom_quat[g1])),
                    hf_pos=tuple(float(c) for c in geom_pos[g1]),
                    hf_size=tuple(float(c) for c in hf_size[:3]),
                    hf_grid=hf_grid,
                )
            )
        # plane-capsule: two pairs per pair, one per capsule end, in
        # collision's interleaved order [pair0_end0, pair0_end1, pair1_end0, ...]
        for g1, g2 in m.pairs_plane_capsule:
            R = _quat_mat_np(geom_quat[g1])
            n = R[:, 2]
            e = np.array([0.0, 1.0, 0.0]) if abs(n[1]) < 0.5 else np.array([0.0, 0.0, 1.0])
            t2 = np.cross(n, e)
            t2 = t2 / max(np.linalg.norm(t2), 1e-12)
            t1 = np.cross(t2, n)
            cb = m.geom_bodyid[g2]
            for end in (0, 1):
                self.pairs.append(
                    _Pair(
                        kind="pc",
                        sphere_geom=g2,
                        sphere_body=cb,
                        radius=float(geom_size[g2][0]),
                        sphere_off=tuple(geom_pos[g2]),
                        plane_point=tuple(geom_pos[g1]),
                        plane_n=tuple(n),
                        frame_t1=tuple(t1),  # the tangent where the capsule is normal to the plane
                        frame_t2=tuple(t2),
                        solref=tuple(0.5 * (geom_solref[g1] + geom_solref[g2])),
                        solimp=tuple(0.5 * (geom_solimp[g1] + geom_solimp[g2])),
                        invweight=float(body_iw[m.geom_bodyid[g1]] + body_iw[cb]),
                        geom1=int(g1),
                        geom2=int(g2),
                        body1=int(m.geom_bodyid[g1]),
                        body2=int(cb),
                        cap_half=float(geom_size[g2][1]),
                        cap_quat=tuple(float(c) for c in geom_quat[g2]),
                        cap_end=end,
                    )
                )
        # sphere-capsule (the sphere is geom1) and capsule-capsule (the
        # geom1 capsule's center and radius in sphere_off1 / radius1)
        for kind, pairs in (("sc", m.pairs_sphere_capsule), ("cc", m.pairs_capsule_capsule)):
            for g1, g2 in pairs:
                b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
                self.pairs.append(
                    _Pair(
                        kind=kind,
                        sphere_geom=g2,
                        sphere_body=b2,
                        radius=float(geom_size[g2][0]),
                        sphere_off=tuple(geom_pos[g2]),
                        plane_point=(0.0, 0.0, 0.0),
                        plane_n=(0.0, 0.0, 1.0),
                        frame_t1=(0.0, 1.0, 0.0),
                        frame_t2=(-1.0, 0.0, 0.0),
                        solref=tuple(0.5 * (geom_solref[g1] + geom_solref[g2])),
                        solimp=tuple(0.5 * (geom_solimp[g1] + geom_solimp[g2])),
                        invweight=float(body_iw[b1] + body_iw[b2]),
                        geom1=int(g1),
                        geom2=int(g2),
                        body1=int(b1),
                        body2=int(b2),
                        radius1=float(geom_size[g1][0]),
                        sphere_off1=tuple(geom_pos[g1]),
                        cap_half=float(geom_size[g2][1]),
                        cap_quat=tuple(float(c) for c in geom_quat[g2]),
                        cap_half1=float(geom_size[g1][1]) if kind == "cc" else 0.0,
                        cap_quat1=(tuple(float(c) for c in geom_quat[g1]) if kind == "cc"
                                   else (1.0, 0.0, 0.0, 0.0)),
                    )
                )
        self.npair = len(self.pairs)

        # Newton-Hessian sparsity: the tree ancestor pattern, a clique over
        # both chains of every pair, closed under reverse-elimination fill-in
        hess = anc.copy()
        for pr in self.pairs:
            dofs = sorted(set(chains[pr.body1]) | set(chains[pr.body2]))
            for i_d in dofs:
                for j_d in dofs:
                    if j_d <= i_d:
                        hess[i_d, j_d] = True
        for k in reversed(range(m.nv)):
            ancs = [i for i in range(k) if hess[k, i]]
            for a_i in ancs:
                for b_i in ancs:
                    if b_i <= a_i:
                        hess[a_i, b_i] = True
        self.hess = hess

        self.lim_joints = [j for j in range(m.njnt) if m.jnt_limited[j]]

        # rows of the (ndr, B) per-env parameter array
        self.dr_rows: Dict[str, Tuple[int, int]] = {}
        r = 0
        for name, n in (
            ("mass", m.nbody),
            ("inertia", m.nbody * 3),
            ("ipos", m.nbody * 3),
            ("gain0", m.nu),
            ("bias1", m.nu),
            ("bias2", m.nu),
            ("pair_mu", self.npair),
        ):
            self.dr_rows[name] = (r, n)
            r += n
        self.ndr = r

        # rows of the (ncache, B) block of the last forward pass's caches
        self.cache_rows: Dict[str, Tuple[int, int]] = {}
        r = 0
        for name, n in (
            ("qacc", m.nv),
            ("xpos", m.nbody * 3),
            ("xquat", (m.nbody - 1) * 4),
            ("xd_ang", (m.nbody - 1) * 3),
            ("xd_vel", (m.nbody - 1) * 3),
            ("site_xpos", m.nsite * 3),
            ("qfrc_actuator", m.nv),
            ("con_dist", self.npair),
            ("con_pos", self.npair * 3),
        ):
            self.cache_rows[name] = (r, n)
            r += n
        self.ncache = r


# ---------------------------------------------------------------------------
# program emitters (operate on value-algebra objects)
# ---------------------------------------------------------------------------


def _impedance(solimp: tuple, pos):
    """MuJoCo impedance d(pos) with STATIC solimp (constraint.impedance)."""
    dmin, dmax, width, mid, power = (float(x) for x in solimp)
    if _c(pos):
        x = min(max(abs(pos) / max(width, _MINVAL), 0.0), 1.0)
        a = 1.0 / max(mid, _MINVAL) ** (power - 1.0)
        b = 1.0 / max(1.0 - mid, _MINVAL) ** (power - 1.0)
        y = a * x**power if x < mid else 1.0 - b * (1.0 - x) ** power
        return min(max(dmin + y * (dmax - dmin), 1e-4), 0.9999)
    return _impedance_of(_impedance_constants(solimp), power, pos)


def _impedance_constants(solimp: tuple) -> tuple:
    """(dmin, dmax - dmin, width, mid, a, b): the constants the impedance
    of a value folds in, as Python floats."""
    dmin, dmax, width, mid, power = (float(x) for x in solimp)
    return (dmin, dmax - dmin, max(width, _MINVAL), mid,
            1.0 / max(mid, _MINVAL) ** (power - 1.0),
            1.0 / max(1.0 - mid, _MINVAL) ** (power - 1.0))


def _impedance_of(c, power: float, pos):
    """The impedance at a value ``pos`` from its constants ``c``
    (``_impedance_constants``' order): Python floats folded in, or values
    a box table holds, in the same operations and order."""
    dmin, ddiff, width, mid, a, b = c
    x = clip(div_const(abs_(pos), width) if _c(width) else abs_(pos) / width, 0.0, 1.0)
    if power == 2.0:
        y_lo = a * x * x
        one_minus = 1.0 - x
        y_hi = 1.0 - b * one_minus * one_minus
    else:
        y_lo = a * pow_const(x, power)
        y_hi = 1.0 - b * pow_const(1.0 - x, power)
    y = where(x < mid, y_lo, y_hi)
    return clip(dmin + y * ddiff, 1e-4, 0.9999)


def _kb(solref: tuple, solimp: tuple) -> Tuple[float, float]:
    """Static stiffness/damping from solref (constraint._kb)."""
    dmax = float(solimp[1])
    timeconst, dampratio = float(solref[0]), float(solref[1])
    if timeconst <= 0 or dampratio <= 0:
        return (
            -timeconst / max(dmax * dmax, _MINVAL),
            -dampratio / max(dmax, _MINVAL),
        )
    k = 1.0 / max(dmax * dmax * timeconst * timeconst * dampratio * dampratio, _MINVAL)
    b = 2.0 / max(dmax * timeconst, _MINVAL)
    return k, b


class _Row(NamedTuple):
    J: dict  # dof -> value
    aref: object
    D: object
    R: object
    floss: float
    fric: bool


def _emit_fk(s: _Static, q, dr):
    """Forward kinematics; returns xpos/xquat per body + anchors/axes."""
    xpos = [None] * s.nbody
    xquat = [None] * s.nbody
    xanchor = [None] * s.njnt
    xaxis = [None] * s.njnt
    xpos[0] = [0.0, 0.0, 0.0]
    xquat[0] = [1.0, 0.0, 0.0, 0.0]
    for b in range(1, s.nbody):
        p = s.body_parentid[b]
        j = s.body_jntid[b]
        if j != -1 and s.jnt_type[j] == JNT_FREE:
            qa = s.jnt_qposadr[j]
            pos = [q[qa], q[qa + 1], q[qa + 2]]
            raw = [q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6]]
            n2 = add(
                add(mul(raw[0], raw[0]), mul(raw[1], raw[1])),
                add(mul(raw[2], raw[2]), mul(raw[3], raw[3])),
            )
            inv = rsqrt(n2)
            quat = [mul(raw[i], inv) for i in range(4)]
            xpos[b], xquat[b] = pos, quat
            xanchor[j] = pos
            xaxis[j] = [float(x) for x in s.jnt_axis[j]]
            continue
        bq = [float(x) for x in s.body_quat[b]]
        bp = [float(x) for x in s.body_pos[b]]
        frame_quat = qmul(xquat[p], bq)
        frame_pos = vadd3(xpos[p], qrot(bp, xquat[p]))
        if j == -1:  # fixed body
            xpos[b], xquat[b] = frame_pos, frame_quat
            continue
        qa = s.jnt_qposadr[j]
        angle = sub(q[qa], float(s.qpos0[qa]))
        half = mul(0.5, angle)
        ch, sh = cos(half), sin(half)
        ax = [float(x) for x in s.jnt_axis[j]]
        qloc = [ch, mul(ax[0], sh), mul(ax[1], sh), mul(ax[2], sh)]
        quat = qmul(frame_quat, qloc)
        jp_ = [float(x) for x in s.jnt_pos[j]]
        anchor = vadd3(frame_pos, qrot(jp_, frame_quat))
        pos = vsub3(anchor, qrot(jp_, quat))
        xpos[b], xquat[b] = pos, quat
        xanchor[j] = anchor
        xaxis[j] = qrot(ax, quat)
    return xpos, xquat, xanchor, xaxis


def _spatial_inertia(mass, inertia, offset, R):
    """Dense symmetric 6x6 spatial inertia (ops.math.transform_inertia)."""
    I3 = [[0.0] * 3 for _ in range(3)]
    for i in range(3):
        for k in range(i, 3):
            acc = 0.0
            for jj in range(3):
                acc = fma(acc, mul(R[i][jj], inertia[jj]), R[k][jj])
            I3[i][k] = acc
            I3[k][i] = acc
    c = offset
    cdot = vdot3(c, c)
    I6 = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for k in range(i, 3):
            delta = cdot if i == k else 0.0
            v = add(I3[i][k], mul(mass, sub(delta, mul(c[i], c[k]))))
            I6[i][k] = v
            I6[k][i] = v
    cx = [
        [0.0, neg(c[2]), c[1]],
        [c[2], 0.0, neg(c[0])],
        [neg(c[1]), c[0], 0.0],
    ]
    for i in range(3):
        for k in range(3):
            v = mul(mass, cx[i][k])
            I6[i][3 + k] = v
            I6[3 + k][i] = v
    for i in range(3):
        I6[3 + i][3 + i] = mass
    return I6


def _inert_mv(I6, m6):
    """6x6 spatial inertia times a 6-vector (list of 6 values)."""
    return [
        functools.reduce(add, [mul(I6[i][k], m6[k]) for k in range(6)])
        for i in range(6)
    ]


def _flat(x):
    """The leaves of nested lists, tuples and dicts (None dropped)."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _flat(y)
    elif x is not None:
        yield x


def _sink(values):
    """One value that reads every distinct non-constant leaf of
    ``values``: their sum, taken pairwise (a tree of depth log2 n), so the
    sum adds little to a thread's dependent chain. 0.0 if there is none."""
    seen, vals = set(), []
    for x in _flat(values):
        if not _c(x) and id(x) not in seen:
            seen.add(id(x))
            vals.append(x)
    while len(vals) > 1:
        vals = [add(vals[i], vals[i + 1]) if i + 1 < len(vals) else vals[i]
                for i in range(0, len(vals), 2)]
    return vals[0] if vals else 0.0


def _emit_forward(s: _Static, q, v, ctrl, dr, phase_limit: Optional[str] = None,
                  sink: bool = False):
    """One full forward-dynamics pass (pipeline.forward equivalent).

    ``phase_limit`` (one of ``PHASES``) cuts the pass after that phase, as
    ``puppax/physics/soa.py``'s ``PHASE_LIMIT`` does for the kernel-time
    probes: the outputs not yet computed are padded with ``q[0]``. The
    padding leaves every value that only those outputs read dead, and a
    compiler drops it; ``sink`` (probes only) adds the entry ``sink``, the
    ``_sink`` of every value the cut pass computed, which keeps them live."""
    if phase_limit not in PHASES:
        raise ValueError(f"phase_limit {phase_limit!r} is not one of {PHASES}")
    if s.boxes is not None and (phase_limit is not None or sink):
        raise NotImplementedError("the phase cuts and the sink row are emitted for models "
                                  "without boxes (the kernel-time probes' model)")
    xpos, xquat, xanchor, xaxis = _emit_fk(s, q, dr)

    # inertial frames (DR ipos) + subtree COM of the single tree
    mass = [dr["mass"][b] for b in range(s.nbody)]
    xipos = [None] * s.nbody
    ximat = [None] * s.nbody
    for b in range(1, s.nbody):
        ip = [dr["ipos"][3 * b + i] for i in range(3)]
        xipos[b] = vadd3(xpos[b], qrot(ip, xquat[b]))
        iq = [float(x) for x in s.body_iquat[b]]
        ximat[b] = quat_to_mat(qmul(xquat[b], iq))
    tot_mass = functools.reduce(add, mass[1:])
    mom = [0.0, 0.0, 0.0]
    for b in range(1, s.nbody):
        mom = vadd3(mom, vscale3(xipos[b], mass[b]))
    inv_tot = 1.0 / maximum(materialize(tot_mass, mom[0]), 1e-12)
    com_root = vscale3(mom, inv_tot)
    kept = [xanchor, xaxis, xipos, ximat, com_root]  # what the cuts' sink reads

    def _phase_out(**kw):
        pad = dict(
            qacc=[q[0]] * s.nv, qacc_smooth=[q[0]] * s.nv,
            qfrc_actuator=[q[0]] * s.nv,
            xpos=xpos, xquat=xquat,
            cvel=[([q[0]] * 3, [q[0]] * 3)] * s.nbody,
            com_root=[q[0]] * 3,
            con_dist=[q[0]] * s.npair,
            con_pos=[[q[0]] * 3] * s.npair,
            sites=[[q[0]] * 3] * s.nsite,
        )
        pad.update(kw)
        if sink:
            pad["sink"] = _sink(kept)
        return pad

    if phase_limit == "fk":
        return _phase_out()

    # com-frame spatial inertias
    cinert = [None] * s.nbody
    for b in range(1, s.nbody):
        inertia = [dr["inertia"][3 * b + i] for i in range(3)]
        offset = vsub3(xipos[b], com_root)
        cinert[b] = _spatial_inertia(mass[b], inertia, offset, ximat[b])

    # dof axes about the root com
    cdof = [None] * s.nv  # each (ang3, lin3)
    for j in range(s.njnt):
        b = s.jnt_bodyid[j]
        d = s.jnt_dofadr[j]
        if s.jnt_type[j] == JNT_FREE:
            for i in range(3):
                e = [0.0, 0.0, 0.0]
                e[i] = 1.0
                cdof[d + i] = ([0.0, 0.0, 0.0], e)
            R = quat_to_mat(xquat[b])
            off = vsub3(com_root, xanchor[j])
            for i in range(3):
                axis = [R[0][i], R[1][i], R[2][i]]  # column i = body axis
                cdof[d + 3 + i] = (axis, vcross3(axis, off))
        else:
            ax = xaxis[j]
            off = vsub3(com_root, xanchor[j])
            cdof[d] = (ax, vcross3(ax, off))

    kept.extend([cinert, cdof])
    if phase_limit == "compos":
        return _phase_out()

    # com velocities (forward pass)
    cvel = [None] * s.nbody
    cvel[0] = ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    cdof_dot = [([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])] * s.nv
    for b in range(1, s.nbody):
        p = s.body_parentid[b]
        j = s.body_jntid[b]
        if j == -1:
            cvel[b] = cvel[p]
            continue
        d = s.jnt_dofadr[j]
        if s.jnt_type[j] == JNT_FREE:
            vp = cvel[p]
            v_trans = (vp[0], vadd3(vp[1], [v[d], v[d + 1], v[d + 2]]))
            acc = v_trans
            for i in range(3):
                cdof_dot[d + 3 + i] = motion_cross(v_trans, cdof[d + 3 + i])
                ang, lin = cdof[d + 3 + i]
                acc = (
                    vadd3(acc[0], vscale3(ang, v[d + 3 + i])),
                    vadd3(acc[1], vscale3(lin, v[d + 3 + i])),
                )
            cvel[b] = acc
        else:
            cdof_dot[d] = motion_cross(cvel[p], cdof[d])
            ang, lin = cdof[d]
            cvel[b] = (
                vadd3(cvel[p][0], vscale3(ang, v[d])),
                vadd3(cvel[p][1], vscale3(lin, v[d])),
            )

    kept.extend([cvel, cdof_dot])
    if phase_limit == "comvel":
        return _phase_out()

    # CRB mass matrix (sparse entries over the ancestor pattern)
    crb = [None] + [[row[:] for row in cinert[b]] for b in range(1, s.nbody)]
    for b in range(s.nbody - 1, 0, -1):
        p = s.body_parentid[b]
        if p > 0:
            for i in range(6):
                for k in range(6):
                    crb[p][i][k] = add(crb[p][i][k], crb[b][i][k])
    F = [None] * s.nv
    for d in range(s.nv):
        b = s.dof_body[d]
        m6 = list(cdof[d][0]) + list(cdof[d][1])
        F[d] = _inert_mv(crb[b], m6)
    M: Dict[Tuple[int, int], object] = {}
    for jd in range(s.nv):
        for kd in range(jd + 1):
            if not s.anc[jd, kd]:
                continue
            m6 = list(cdof[kd][0]) + list(cdof[kd][1])
            acc = 0.0
            for i in range(6):
                acc = fma(acc, F[jd][i], m6[i])
            if jd == kd:
                acc = add(acc, float(s.dof_armature[jd]))
            M[(jd, kd)] = acc

    kept.append(M)
    if phase_limit == "crb":
        return _phase_out()

    # RNE bias forces
    cacc = [None] * s.nbody
    g = s.gravity
    cacc[0] = ([0.0, 0.0, 0.0], [-g[0], -g[1], -g[2]])
    for b in range(1, s.nbody):
        p = s.body_parentid[b]
        j = s.body_jntid[b]
        a = cacc[p]
        if j != -1:
            d = s.jnt_dofadr[j]
            n = 6 if s.jnt_type[j] == JNT_FREE else 1
            for dd in range(d, d + n):
                ang, lin = cdof_dot[dd]
                a = (
                    vadd3(a[0], vscale3(ang, v[dd])),
                    vadd3(a[1], vscale3(lin, v[dd])),
                )
        cacc[b] = a
    total = [None] * s.nbody
    for b in range(1, s.nbody):
        v6 = list(cvel[b][0]) + list(cvel[b][1])
        a6 = list(cacc[b][0]) + list(cacc[b][1])
        Iv = _inert_mv(cinert[b], v6)
        Ia = _inert_mv(cinert[b], a6)
        crossed = motion_cross_force(cvel[b], (Iv[:3], Iv[3:]))
        cf = list(crossed[0]) + list(crossed[1])
        total[b] = [add(Ia[i], cf[i]) for i in range(6)]
    for b in range(s.nbody - 1, 0, -1):
        p = s.body_parentid[b]
        if p > 0:
            total[p] = [add(total[p][i], total[b][i]) for i in range(6)]
    qfrc_bias = [0.0] * s.nv
    for d in range(s.nv):
        b = s.dof_body[d]
        m6 = list(cdof[d][0]) + list(cdof[d][1])
        acc = 0.0
        for i in range(6):
            acc = fma(acc, m6[i], total[b][i])
        qfrc_bias[d] = acc

    kept.append(qfrc_bias)
    if phase_limit == "rne":
        return _phase_out()

    # passive + actuation
    qfrc_passive = [mul(-float(s.dof_damping[d]), v[d]) for d in range(s.nv)]
    qfrc_act = [0.0] * s.nv
    for a in range(s.nu):
        j = s.actuator_jntid[a]
        qa, d = s.jnt_qposadr[j], s.jnt_dofadr[j]
        force = add(
            mul(dr["gain0"][a], ctrl[a]),
            add(
                float(s.actuator_b0[a]),
                add(mul(dr["bias1"][a], q[qa]), mul(dr["bias2"][a], v[d])),
            ),
        )
        lo, hi = float(s.forcerange[a][0]), float(s.forcerange[a][1])
        force = clip(materialize(force, v[0]), lo, hi)
        qfrc_act[d] = add(qfrc_act[d], force)

    qfrc_smooth = [
        add(qfrc_passive[d], sub(qfrc_act[d], qfrc_bias[d])) for d in range(s.nv)
    ]
    qacc_smooth = _ldl_solve_dict(s, M, qfrc_smooth)

    kept.extend([qfrc_act, qacc_smooth])
    if phase_limit == "smooth":
        return _phase_out(qacc=qacc_smooth, qacc_smooth=qacc_smooth)

    # ---- contacts: ALL candidate pairs, no caps (C semantics) ----
    con_dist, con_pos, rows_con = [], [], []
    box = None
    for pi, pr in enumerate(s.pairs):
        if pr.kind == "bs":  # the box loop's rows, at the first box pair's place
            if pi == s.boxes.first:
                box = _BoxRows(s, xpos, xquat, com_root, cdof, v, dr["pair_mu"])
                rows_con.append(box)
            con_dist.append(None)
            con_pos.append(None)
            continue
        b = pr.sphere_body
        off = [float(x) for x in pr.sphere_off]
        center = vadd3(xpos[b], qrot(off, xquat[b]))
        if pr.kind == "ps":
            n = [float(x) for x in pr.plane_n]
            pp = [float(x) for x in pr.plane_point]
            dist = sub(vdot3(n, vsub3(center, pp)), pr.radius)
            cpos = vsub3(center, vscale3(n, add(pr.radius, mul(0.5, dist))))
            t1 = [float(x) for x in pr.frame_t1]
            t2 = [float(x) for x in pr.frame_t2]
            dof_coeff = {d: 1.0 for d in s.chains[b]}
        elif pr.kind == "hs":
            n, cpos, dist, t1, t2 = _emit_hfield_sphere(pr, center)
            # the normal points from the heightfield to the sphere: J = +jac
            dof_coeff = {d: 1.0 for d in s.chains[b]}
        elif pr.kind == "pc":
            n, cpos, dist, t1, t2 = _emit_plane_capsule(pr, center, xquat[b])
            # the normal points from the plane to the capsule: J = +jac
            dof_coeff = {d: 1.0 for d in s.chains[b]}
        elif pr.kind in ("sc", "cc"):
            b1 = pr.body1
            c1 = vadd3(xpos[b1], qrot([float(x) for x in pr.sphere_off1], xquat[b1]))
            if pr.kind == "sc":
                n, cpos, dist, t1, t2 = _emit_sphere_capsule(pr, c1, center, xquat[b])
            else:
                n, cpos, dist, t1, t2 = _emit_capsule_capsule(pr, c1, xquat[b1], center,
                                                              xquat[b])
            # the normal points from geom1 (the sphere, or capsule 1) to
            # the geom2 capsule: J = J2 - J1
            dof_coeff = _relative_dofs(s, b, b1)
        else:  # sphere-sphere (collision._sphere_sphere semantics)
            b1 = pr.body1
            off1 = [float(x) for x in pr.sphere_off1]
            c1 = vadd3(xpos[b1], qrot(off1, xquat[b1]))
            delta = vsub3(center, c1)
            length = sqrt(materialize(vdot3(delta, delta), center[0]))
            inv_len = 1.0 / maximum(length, 1e-12)
            n = [materialize(delta[i], length) * inv_len for i in range(3)]
            dist = sub(length, pr.radius1 + pr.radius)
            cpos = vadd3(c1, vscale3(n, add(pr.radius1, mul(0.5, dist))))
            t1, t2 = _dynamic_frame(n, length)
            # J = J2 - J1: shared (base) dofs cancel exactly (same offset)
            dof_coeff = _relative_dofs(s, b, b1)
        con_dist.append(dist)
        con_pos.append(cpos)
        rows_con.extend(_pair_rows(s, pr, dr["pair_mu"][pi], n, t1, t2, cpos, dist, dof_coeff,
                                   com_root, cdof, v))

    # ---- dof friction rows (static D/R) ----
    rows_fric = []
    for d in s.dof_frictional:
        imp = _impedance(tuple(s.dof_solimp[d]), 0.0)  # static float
        K, Bc = _kb(tuple(s.dof_solref[d]), tuple(s.dof_solimp[d]))
        R = max(max((1.0 - imp) / max(imp, _MINVAL), _MINVAL)
                * float(s.dof_invweight0[d]), _MINVAL)
        rows_fric.append(
            _Row(
                J={d: 1.0},
                aref=mul(-Bc, v[d]),
                D=1.0 / R,
                R=R,
                floss=float(s.dof_frictionloss[d]),
                fric=True,
            )
        )

    # ---- joint limit rows ----
    rows_lim = []
    for j in s.lim_joints:
        qa, d = s.jnt_qposadr[j], s.jnt_dofadr[j]
        lo, hi = float(s.jnt_range[j][0]), float(s.jnt_range[j][1])
        dist_lo = sub(q[qa], lo)
        dist_hi = sub(hi, q[qa])
        lower = materialize(dist_lo, v[0]) < materialize(dist_hi, v[0])
        side = where(lower, 1.0, -1.0)
        pos = where(
            lower, materialize(dist_lo, side), materialize(dist_hi, side)
        ) - float(s.jnt_margin[j])
        imp = _impedance(tuple(s.jnt_solimp[j]), pos)
        K, Bc = _kb(tuple(s.jnt_solref[j]), tuple(s.jnt_solimp[j]))
        jvel = mul(side, v[d])
        aref = sub(mul(-imp * K, pos), mul(Bc, jvel))
        R = maximum(
            maximum((1.0 - imp) / maximum(imp, _MINVAL), _MINVAL)
            * float(s.dof_invweight0[d]),
            _MINVAL,
        )
        D = where(pos < 0, 1.0 / R, 0.0)
        rows_lim.append(_Row(J={d: side}, aref=aref, D=D, R=R, floss=0.0, fric=False))

    kept.extend([con_dist, con_pos, rows_fric, rows_lim, rows_con])
    if phase_limit == "efc":
        return _phase_out(qacc=qacc_smooth, qacc_smooth=qacc_smooth,
                          con_dist=con_dist, con_pos=con_pos)

    rows = rows_fric + rows_lim + rows_con
    qacc = _emit_newton(s, M, qacc_smooth, rows, v)

    return dict(
        qacc=qacc,
        qacc_smooth=qacc_smooth,
        xpos=xpos,
        xquat=xquat,
        cvel=cvel,
        com_root=com_root,
        qfrc_actuator=qfrc_act,
        con_dist=con_dist,  # None at a box pair: ``boxes`` holds those
        con_pos=con_pos,
        boxes=box,
        sites=[
            vadd3(
                xpos[s.site_bodyid[i]],
                qrot([float(x) for x in s.site_pos[i]], xquat[s.site_bodyid[i]]),
            )
            for i in range(s.nsite)
        ],
    )


def _emit_hfield_sphere(pr: _Pair, center):
    """The hfield-sphere contact of one pair (collision._hfield_sphere, as
    puppax/physics/soa.py emits it): the footprint's cell and fractions,
    its four corners by ``grid_at``, the bilinear height and slopes, the
    tangent-plane normal, distance and midpoint (``_PAD_DIST`` off the
    grid) and the dynamic frame. Returns (n, cpos, dist, t1, t2)."""
    R = pr.hf_R
    rx, ry, ez = pr.hf_size
    grid = pr.hf_grid
    nrow, ncol = len(grid), len(grid[0])
    ref0 = materialize(center[0], center[0])
    d0 = vsub3(center, pr.hf_pos)
    # p = R^T (c - hp): the sphere center in the heightfield frame
    p = [
        materialize(add(add(mul(R[0][j], d0[0]), mul(R[1][j], d0[1])), mul(R[2][j], d0[2])),
                    ref0)
        for j in range(3)
    ]
    # the footprint's fractional grid coordinates
    uc = div_const(p[0] + rx, 2.0 * rx) * (ncol - 1)
    vc = div_const(p[1] + ry, 2.0 * ry) * (nrow - 1)
    outside = (abs_(p[0]) > rx) | (abs_(p[1]) > ry)
    iu = clip(floor(uc), 0.0, float(ncol - 2))
    iv = clip(floor(vc), 0.0, float(nrow - 2))
    fu = clip(uc - iu, 0.0, 1.0)
    fv = clip(vc - iv, 0.0, 1.0)
    c00, c01 = grid_at(grid, iv, iu), grid_at(grid, iv, iu, 0, 1)
    c10, c11 = grid_at(grid, iv, iu, 1, 0), grid_at(grid, iv, iu, 1, 1)
    gu, gv = 1.0 - fu, 1.0 - fv
    h = ez * (gu * (gv * c00 + fv * c10) + fu * (gv * c01 + fv * c11))
    dhdx = ez * (gv * (c01 - c00) + fv * (c11 - c10)) * ((ncol - 1) / (2.0 * rx))
    dhdy = ez * (gu * (c10 - c00) + fu * (c11 - c01)) * ((nrow - 1) / (2.0 * ry))
    inv_nn = 1.0 / sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    n_loc = [-dhdx * inv_nn, -dhdy * inv_nn, inv_nn]
    dist = (p[2] - h) * n_loc[2] - pr.radius
    dist = where(outside, _PAD_DIST, dist)
    # back to world: n = R n_loc (an identity R folds away)
    n = [
        materialize(add(add(mul(R[i][0], n_loc[0]), mul(R[i][1], n_loc[1])),
                        mul(R[i][2], n_loc[2])), ref0)
        for i in range(3)
    ]
    safe = where(outside, 0.0, dist)
    cpos = [materialize(sub(center[i], mul(n[i], pr.radius + 0.5 * safe)), ref0)
            for i in range(3)]
    t1, t2 = _dynamic_frame(n, ref0)
    return n, cpos, dist, t1, t2


def _dynamic_frame(n, ref):
    """The tangents (t1, t2) of the contact frame of a unit normal ``n``
    (mju_makeFrame, as collision._make_frames): helper axis y where |n_y| <
    0.5, else z; t2 = normalize(n x e); t1 = t2 x n."""
    use_y = abs_(n[1]) < 0.5
    ax = [0.0, where(use_y, 1.0, 0.0), where(use_y, 0.0, 1.0)]
    t2 = vcross3(n, ax)
    t2n = maximum(sqrt(materialize(vdot3(t2, t2), ref)), 1e-12)
    t2 = [materialize(t2[i], ref) / t2n for i in range(3)]
    return vcross3(t2, n), t2


def _relative_dofs(s: _Static, b2: int, b1: int) -> Dict[int, float]:
    """The signed dof coefficients of J = J2 - J1 for a contact between
    bodies b1 and b2: the dofs of both chains, the shared ones cancelled."""
    coeff = {}
    for d in s.chains[b2]:
        coeff[d] = coeff.get(d, 0.0) + 1.0
    for d in s.chains[b1]:
        coeff[d] = coeff.get(d, 0.0) - 1.0
    return {d: c for d, c in coeff.items() if c != 0.0}


def _capsule_axis(xquat_b, cap_quat: tuple):
    """The world z axis of a capsule on a body of rotation ``xquat_b``."""
    return qrot([0.0, 0.0, 1.0], qmul(xquat_b, [float(x) for x in cap_quat]))


def _emit_plane_capsule(pr: _Pair, center, xquat_b):
    """The plane-capsule contact of one capsule end (collision._plane_capsule,
    as puppax/physics/soa.py emits it): the end's plane-sphere contact; the
    first tangent the capsule axis projected onto the plane, or the constant
    mju_makeFrame tangent where that projection's norm is at most 1e-8 (both
    computed, one selected). Returns (n, cpos, dist, t1, t2)."""
    ref0 = materialize(center[0], center[0])
    axis = _capsule_axis(xquat_b, pr.cap_quat)
    sgn = -1.0 if pr.cap_end == 0 else 1.0
    end = vadd3(center, vscale3(axis, mul(sgn, pr.cap_half)))
    n = [float(x) for x in pr.plane_n]
    pp = [float(x) for x in pr.plane_point]
    dist = sub(vdot3(n, vsub3(end, pp)), pr.radius)
    cpos = vsub3(end, vscale3(n, add(pr.radius, mul(0.5, dist))))
    na = vdot3(n, axis)
    proj = [materialize(sub(axis[i], mul(n[i], na)), ref0) for i in range(3)]
    pn = sqrt(materialize(vdot3(proj, proj), ref0))
    use_proj = pn > 1e-8
    inv_pn = 1.0 / maximum(pn, 1e-12)
    t1 = [where(use_proj, proj[i] * inv_pn, float(pr.frame_t1[i])) for i in range(3)]
    return n, cpos, dist, t1, vcross3(n, t1)


def _emit_sphere_capsule(pr: _Pair, c1, center, xquat_b):
    """The sphere-capsule contact of one pair (collision._sphere_capsule):
    the sphere at ``c1`` against the nearest point of the capsule's axis
    segment. Returns (n, cpos, dist, t1, t2)."""
    ref0 = materialize(center[0], center[0])
    axis = _capsule_axis(xquat_b, pr.cap_quat)
    tpar = clip(materialize(vdot3(vsub3(c1, center), axis), ref0), -pr.cap_half, pr.cap_half)
    nearest = vadd3(center, vscale3(axis, tpar))
    return _virtual_spheres(pr, c1, nearest, ref0)


def _emit_capsule_capsule(pr: _Pair, c1, xquat_b1, center, xquat_b):
    """The capsule-capsule contact of one pair (collision._capsule_capsule):
    the closest points of the two axis segments (Ericson 5.1.9, clamped; s
    recomputed where t was clamped, the ``!=`` of the reference), then their
    sphere-sphere contact. Returns (n, cpos, dist, t1, t2)."""
    ref0 = materialize(center[0], center[0])
    axis1 = _capsule_axis(xquat_b1, pr.cap_quat1)
    axis2 = _capsule_axis(xquat_b, pr.cap_quat)
    a0 = vsub3(c1, vscale3(axis1, pr.cap_half1))
    a1e = vadd3(c1, vscale3(axis1, pr.cap_half1))
    b0 = vsub3(center, vscale3(axis2, pr.cap_half))
    b1e = vadd3(center, vscale3(axis2, pr.cap_half))
    d1v = vsub3(a1e, a0)
    d2v = vsub3(b1e, b0)
    r_ = vsub3(a0, b0)
    a_ = materialize(vdot3(d1v, d1v), ref0)
    e_ = materialize(vdot3(d2v, d2v), ref0)
    f_ = materialize(vdot3(d2v, r_), ref0)
    c_ = materialize(vdot3(d1v, r_), ref0)
    bb = materialize(vdot3(d1v, d2v), ref0)
    denom = a_ * e_ - bb * bb
    sseg = where(denom > 1e-12, clip((bb * f_ - c_ * e_) / maximum(denom, 1e-12), 0.0, 1.0),
                 0.0)
    tseg = (bb * sseg + f_) / maximum(e_, 1e-12)
    t_cl = clip(tseg, 0.0, 1.0)
    sseg = where(tseg != t_cl, clip((bb * t_cl - c_) / maximum(a_, 1e-12), 0.0, 1.0), sseg)
    p1 = vadd3(a0, vscale3(d1v, sseg))
    p2 = vadd3(b0, vscale3(d2v, t_cl))
    return _virtual_spheres(pr, p1, p2, ref0)


def _virtual_spheres(pr: _Pair, p1, p2, ref0):
    """The sphere-sphere contact of spheres of radii ``pr.radius1`` at ``p1``
    and ``pr.radius`` at ``p2`` (the capsule kinds' last step), with the
    dynamic frame. Returns (n, cpos, dist, t1, t2)."""
    delta = vsub3(p2, p1)
    length = sqrt(materialize(vdot3(delta, delta), ref0))
    inv_len = 1.0 / maximum(length, 1e-12)
    n = [materialize(delta[i], ref0) * inv_len for i in range(3)]
    dist = sub(length, pr.radius1 + pr.radius)
    cpos = vadd3(p1, vscale3(n, add(pr.radius1, mul(0.5, dist))))
    t1, t2 = _dynamic_frame(n, ref0)
    return n, cpos, dist, t1, t2


def _pair_rows(s: _Static, pr: _Pair, mu, n, t1, t2, cpos, dist, dof_coeff, com_root, cdof,
               v, consts=None) -> List["_Row"]:
    """The four pyramidal friction-cone rows of one contact (facets t1+,
    t1-, t2+, t2-): J over the dofs of ``dof_coeff`` (each dof's signed
    coefficient), aref, R and D with the pair's friction ``mu``; the pair's
    contact constants folded in from ``pr``, or read from ``consts`` (values,
    ``_contact_constants``' order) where a box loop's boxes differ."""
    offc = vsub3(cpos, com_root)
    jn, jt1, jt2 = {}, {}, {}
    dofs = sorted(dof_coeff)
    for d in dofs:
        ang, lin = cdof[d]
        jac3 = vscale3(vadd3(lin, vcross3(ang, offc)), dof_coeff[d])
        jn[d] = vdot3(n, jac3)
        jt1[d] = vdot3(t1, jac3)
        jt2[d] = vdot3(t2, jac3)
    jn_v = functools.reduce(add, [mul(jn[d], v[d]) for d in dofs])
    jt1_v = functools.reduce(add, [mul(jt1[d], v[d]) for d in dofs])
    jt2_v = functools.reduce(add, [mul(jt2[d], v[d]) for d in dofs])

    if consts is None:
        imp = _impedance(pr.solimp, dist)
        K, Bc = _kb(pr.solref, pr.solimp)
        r_t0 = pr.invweight * 2.0 / s.impratio
    else:
        imp = _impedance_of(consts[3:], float(pr.solimp[4]), dist)
        K, Bc, r_t0 = consts[:3]
    mu2 = mul(mu, mu)
    r_t = mul(mul(r_t0, mu2), add(1.0, mu2))
    base_R = maximum((1.0 - imp) / maximum(imp, _MINVAL), _MINVAL)
    pen_active = dist < 0
    # facet order [t1+, t1-, t2+, t2-]; the -facet reuses mu*jt (IEEE:
    # a + (-x) == a - x), exactly as the JAX emitter does
    base0 = neg(mul(mul(imp, K), dist))
    R = maximum(base_R * materialize(r_t, base_R), _MINVAL)
    D = where(pen_active, 1.0 / R, 0.0)
    rows = []
    for jt, jtv in ((jt1, jt1_v), (jt2, jt2_v)):
        mujt = {d: mul(mu, jt[d]) for d in dofs}
        mujtv = mul(mu, jtv)
        for pos_facet in (True, False):
            if pos_facet:
                J = {d: add(jn[d], mujt[d]) for d in dofs}
                jvel = add(jn_v, mujtv)
            else:
                J = {d: sub(jn[d], mujt[d]) for d in dofs}
                jvel = sub(jn_v, mujtv)
            aref = sub(base0, mul(Bc, jvel))
            rows.append(_Row(J=J, aref=aref, D=D, R=R, floss=0.0, fric=False))


    return rows


def _emit_sphere_box(pr: _Pair, center, R, bp, half):
    """The sphere-box contact of one pair (collision._sphere_box, as
    puppax/physics/soa.py emits it) for a box whose rotation ``R`` (rows),
    position ``bp`` and half-sizes ``half`` are values (the box table's
    entries at the trip): the center in the box frame, the clamp, the
    outside and the inside branch (the nearest face, the first on a tie;
    a center on its plane goes out on the + side), the distance, the
    midpoint of the two surfaces and the dynamic frame. The normal points
    from the sphere into the box. Returns (n, cpos, dist, t1, t2)."""
    ref0 = materialize(center[0], center[0])
    d0 = vsub3(center, bp)
    # p = R^T (c - bp): the sphere center in the box frame
    p = [
        materialize(add(add(mul(R[0][j], d0[0]), mul(R[1][j], d0[1])), mul(R[2][j], d0[2])),
                    ref0)
        for j in range(3)
    ]
    clamped = [clip(p[j], neg(half[j]), half[j]) for j in range(3)]
    absp = [abs_(p[j]) for j in range(3)]
    inside = (absp[0] < half[0]) & (absp[1] < half[1]) & (absp[2] < half[2])
    # outside: the closest surface point
    d_out = vsub3(p, clamped)
    dist_out = sqrt(materialize(vdot3(d_out, d_out), ref0))
    inv_out = 1.0 / maximum(dist_out, 1e-12)
    n_out = [-materialize(d_out[j], ref0) * inv_out for j in range(3)]
    # inside: out along the nearest face (first-min tie-break, as argmin)
    gaps = [half[j] - absp[j] for j in range(3)]
    m0 = where((gaps[0] <= gaps[1]) & (gaps[0] <= gaps[2]), 1.0, 0.0)
    m1 = where(gaps[1] <= gaps[2], 1.0 - m0, 0.0)
    m2 = 1.0 - m0 - m1
    oh = [m0, m1, m2]
    psel = p[0] * m0 + p[1] * m1 + p[2] * m2
    sgn = where(psel >= 0.0, 1.0, -1.0)
    n_in = [-sgn * oh[j] for j in range(3)]
    dist_in = -(gaps[0] * m0 + gaps[1] * m1 + gaps[2] * m2)
    surf_in = [p[j] * (1.0 - oh[j]) + oh[j] * sgn * half[j] for j in range(3)]
    dist = where(inside, dist_in, dist_out) - pr.radius
    n_loc = [where(inside, n_in[j], n_out[j]) for j in range(3)]
    surf_loc = [where(inside, surf_in[j], clamped[j]) for j in range(3)]
    # back to world: n = R n_loc, surface = bp + R surf_loc
    n = [add(add(mul(R[i][0], n_loc[0]), mul(R[i][1], n_loc[1])), mul(R[i][2], n_loc[2]))
         for i in range(3)]
    surface = [
        add(bp[i], add(add(mul(R[i][0], surf_loc[0]), mul(R[i][1], surf_loc[1])),
                       mul(R[i][2], surf_loc[2])))
        for i in range(3)
    ]
    sph_surf = [add(center[i], mul(n[i], pr.radius)) for i in range(3)]
    cpos = [mul(0.5, add(sph_surf[i], surface[i])) for i in range(3)]
    # dynamic contact frame (mju_makeFrame, as collision._make_frames)
    use_y = abs_(materialize(n[1], ref0)) < 0.5
    ax = [0.0, where(use_y, 1.0, 0.0), where(use_y, 0.0, 1.0)]
    t2 = vcross3(n, ax)
    t2n = maximum(sqrt(materialize(vdot3(t2, t2), ref0)), 1e-12)
    t2 = [materialize(t2[i], ref0) / t2n for i in range(3)]
    t1 = vcross3(t2, n)
    return n, cpos, dist, t1, t2


class _BoxRows:
    """The sphere-box rows of one forward pass, in the rows list at the
    place of the first box pair: ``s.boxes.n`` boxes, one row group per
    sphere of ``s.boxes.spheres`` in each, four rows per pair, in the JAX
    emission's order (box by box). ``_emit_newton`` emits them as three
    loops over the boxes (``fori_loop(..., split=True)``):

    * ``rows_and_grad``: per pair the narrowphase, the rows, jar, the
      force and the gradient's terms (the gradient of the rows' dofs is
      the loop's carry); J, jar and D go to arrays, and the contact's
      distance and midpoint too (``contacts`` reads them back);
    * ``hessian``: the Hessian's terms of the rows' pattern (carried);
    * ``jv``: J dx, into the line search's stacked rows.

    Every running sum adds the same terms in the same order as the
    straight-line emission of the same rows would."""

    def __init__(self, s: _Static, xpos, xquat, com_root, cdof, v, mu):
        bx = s.boxes
        self.s, self.bx, self.nsph = s, bx, len(bx.spheres)
        self.centers = [
            vadd3(xpos[p.sphere_body], qrot([float(x) for x in p.sphere_off],
                                            xquat[p.sphere_body]))
            for p in bx.spheres
        ]
        self.com_root, self.cdof, self.v, self.mu = com_root, cdof, v, mu
        self.chains = [sorted(s.chains[p.sphere_body]) for p in bx.spheres]
        self.nrows = 4 * self.nsph * bx.n
        # J's array: per box, per sphere, per facet, the chain's dofs
        self.joff, off = [], 0
        for ch in self.chains:
            self.joff.append(off)
            off += 4 * len(ch)
        self.jstride = off
        self.J = self.dist = self.pos = None

    def rows_and_grad(self, x, grad, jar_os, D_os, os0: int, ref):
        bx, s, nsph = self.bx, self.s, self.nsph
        gdofs = sorted({d for ch in self.chains for d in ch})
        self.J = new_array(bx.n * self.jstride, ref)
        self.dist = new_array(bx.n * nsph, ref)
        self.pos = new_array(bx.n * nsph * 3, ref)

        def body(k, carry):
            g = dict(zip(gdofs, carry))
            tab = [table_at(bx.table, k, c, ref) for c in range(BOX_POSE_COLUMNS)]
            R, bp, half = [tab[0:3], tab[3:6], tab[6:9]], tab[9:12], tab[12:15]
            for j, sp in enumerate(bx.spheres):
                chain = self.chains[j]
                n, cpos, dist, t1, t2 = _emit_sphere_box(sp, self.centers[j], R, bp, half)
                mu = row_at(self.mu, k, nsph, bx.first + j, bx.n)
                c0 = BOX_POSE_COLUMNS + N_CONTACT_CONSTANTS * j
                consts = ([table_at(bx.table, k, c, ref)
                           for c in range(c0, c0 + N_CONTACT_CONSTANTS)] if bx.params else None)
                # J = frame (jac(box) - jac(sphere)) = -jac(sphere): the
                # sphere is geom1, the opposite of the plane-sphere pair
                rows = _pair_rows(s, sp, mu, n, t1, t2, cpos, dist, {d: -1.0 for d in chain},
                                  self.com_root, self.cdof, self.v, consts)
                array_store(self.dist, dist, j, k, nsph)
                for c in range(3):
                    array_store(self.pos, cpos[c], 3 * j + c, k, 3 * nsph)
                for f, r in enumerate(rows):
                    acc = neg(r.aref)
                    for d, jv in r.J.items():
                        acc = fma(acc, jv, x[d])
                    ja_t = materialize(acc, ref)
                    quad = ja_t < 0
                    force = where(quad, -materialize(r.D, ref) * ja_t, 0.0)
                    for d, jv in r.J.items():
                        g[d] = sub(g[d], mul(jv, force))
                    for di, d in enumerate(chain):
                        array_store(self.J, r.J[d], self.joff[j] + f * len(chain) + di, k,
                                    self.jstride)
                    array_store(jar_os, ja_t, os0 + 4 * j + f, k, 4 * nsph)
                    array_store(D_os, materialize(r.D, ref), os0 + 4 * j + f, k, 4 * nsph)
            return [materialize(g[d], ref) for d in gdofs]

        out = fori_loop(bx.n, body, [materialize(grad[d], ref) for d in gdofs], ref, split=True)
        grad = list(grad)
        for d, val in zip(gdofs, out):
            grad[d] = val
        return grad

    def _trip_J(self, k, j: int, f: int):
        chain = self.chains[j]
        return {d: array_load(self.J, self.joff[j] + f * len(chain) + di, k, self.jstride)
                for di, d in enumerate(chain)}

    def hessian(self, H, jar_os, D_os, os0: int, ref):
        nsph = self.nsph
        keys = sorted({(max(d1, d2), min(d1, d2)) for ch in self.chains
                       for d1 in ch for d2 in ch})

        def body(k, carry):
            h = dict(zip(keys, carry))
            for j, chain in enumerate(self.chains):
                for f in range(4):
                    J = self._trip_J(k, j, f)
                    ja = array_load(jar_os, os0 + 4 * j + f, k, 4 * nsph)
                    w = where(ja < 0, array_load(D_os, os0 + 4 * j + f, k, 4 * nsph), 0.0)
                    for a_i, d1 in enumerate(chain):
                        for d2 in chain[: a_i + 1]:
                            hi, lo = (d1, d2) if d1 >= d2 else (d2, d1)
                            h[(hi, lo)] = fma(h[(hi, lo)], mul(w, J[d1]), J[d2])
            return [materialize(h[key], ref) for key in keys]

        out = fori_loop(self.bx.n, body, [materialize(H[key], ref) for key in keys], ref,
                        split=True)
        H = dict(H)
        H.update(zip(keys, out))
        return H

    def jv(self, dx, jv_os, os0: int, ref):
        nsph = self.nsph

        def body(k, carry):
            for j, chain in enumerate(self.chains):
                for f in range(4):
                    J = self._trip_J(k, j, f)
                    acc = 0.0
                    for d in chain:
                        acc = fma(acc, J[d], dx[d])
                    array_store(jv_os, materialize(acc, ref), os0 + 4 * j + f, k, 4 * nsph)
            return []

        fori_loop(self.bx.n, body, [], ref, split=True)

    def contacts(self, con_dist, con_pos):
        """Fill the box pairs' entries of the contact report from the
        arrays the first loop wrote."""
        bx, nsph = self.bx, self.nsph
        for i in range(bx.n * nsph):
            con_dist[bx.first + i] = array_load(self.dist, i)
            con_pos[bx.first + i] = [array_load(self.pos, 3 * i + c) for c in range(3)]

    def holds(self, pair: int) -> bool:
        return self.bx.first <= pair < self.bx.first + self.bx.n * self.nsph

    def fold_dist(self, acc, pairs: List[int], fn, ref):
        """``acc = fn(acc, dist)`` over the distances of the box pairs
        ``pairs`` in pair order, as one loop over the boxes: the same
        spheres of every box (``pairs`` must hold them all)."""
        bx, nsph = self.bx, self.nsph
        slots = sorted({(p - bx.first) % nsph for p in pairs})
        if sorted(pairs) != [bx.first + k * nsph + j for k in range(bx.n) for j in slots]:
            raise ValueError("fold_dist reads the same spheres of every box")

        def body(k, carry):
            (a,) = carry
            for j in slots:
                a = fn(a, array_load(self.dist, j, k, nsph))
            return [materialize(a, ref)]

        (acc,) = fori_loop(bx.n, body, [materialize(acc, ref)], ref)
        return acc


# ---------------------------------------------------------------------------
# sparse LDL^T over the kinematic-tree pattern (reverse elimination)
# ---------------------------------------------------------------------------


def _ldl_factor_dict(s: _Static, M: Dict[Tuple[int, int], object], pattern):
    """Factor M = L^T D L (L unit lower, entries only on ``pattern``)."""
    A = dict(M)
    L: Dict[int, Dict[int, object]] = {}
    D = [None] * s.nv
    for k in reversed(range(s.nv)):
        d = A[(k, k)]
        D[k] = d
        inv_d = 1.0 / d
        ancs = [i for i in range(k) if pattern[k, i]]
        c = {i: mul(A[(k, i)], inv_d) for i in ancs}
        for i in ancs:
            for jj in ancs:
                if jj <= i:
                    A[(i, jj)] = sub(A[(i, jj)], mul(c[i], A[(k, jj)]))
        L[k] = c
    return L, D


def _ldl_solve_fac(s: _Static, L, D, b, pattern):
    """Solve (L^T D L) x = b given the factor."""
    nv = s.nv
    y = [None] * nv
    for i in reversed(range(nv)):
        acc = b[i]
        for k in range(i + 1, nv):
            if pattern[k, i]:
                acc = sub(acc, mul(L[k][i], y[k]))
        y[i] = acc
    z = [mul(y[k], 1.0 / D[k]) for k in range(nv)]
    x = [None] * nv
    for k in range(nv):
        acc = z[k]
        for i in range(k):
            if pattern[k, i]:
                acc = sub(acc, mul(L[k][i], x[i]))
        x[k] = acc
    return x


def _ldl_solve_dict(s: _Static, M, b, pattern=None):
    pattern = s.anc if pattern is None else pattern
    L, D = _ldl_factor_dict(s, M, pattern)
    return _ldl_solve_fac(s, L, D, b, pattern)


def _sym_mv(s: _Static, M: Dict[Tuple[int, int], object], x):
    """Symmetric sparse matvec over the ancestor pattern."""
    out = [0.0] * s.nv
    for (j, k), val in M.items():
        out[j] = fma(out[j], val, x[k])
        if j != k:
            out[k] = fma(out[k], val, x[j])
    return out


# ---------------------------------------------------------------------------
# Newton solve with exact line search (solver.py semantics)
# ---------------------------------------------------------------------------


def _emit_newton(s: _Static, M, qacc_smooth, rows: List[_Row], v):
    """The Newton step. ``rows`` may hold one ``_BoxRows``, the box loop's
    rows: each stage that goes over the rows runs its loop there, and the
    line search's stacked rows are arrays the loops write into."""
    x = list(qacc_smooth)
    nr = len(rows)
    if nr == 0:
        return x
    ref = None
    for val in x:
        if not _c(val):
            ref = val
            break
    box = next((r for r in rows if isinstance(r, _BoxRows)), None)

    for _ in range(max(s.solver_iterations, 1)):
        if box is not None:
            # the one-sided rows' places in the stacked rows, the box rows' block
            os_at, n_os = {}, 0
            for i, r in enumerate(rows):
                if r is box:
                    box_os0 = n_os
                    n_os += box.nrows
                elif not r.fric:
                    os_at[i] = n_os
                    n_os += 1
            jar_arr, jv_arr, D_arr = (new_array(n_os, ref) for _ in range(3))
        jar = []
        for r in rows:
            if r is box:
                jar.append(None)
                continue
            acc = neg(r.aref)
            for d, jv in r.J.items():
                acc = fma(acc, jv, x[d])
            jar.append(acc)

        # per-row force + quadratic-zone mask
        force, quadw = [], []
        for r, ja in zip(rows, jar):
            if r is box:
                force.append(None)
                quadw.append(None)
                continue
            ja_t = materialize(ja, ref)
            if r.fric:
                thresh = r.floss * r.R  # static for friction rows
                quad = abs_(ja_t) <= thresh
                f = where(quad, -r.D * ja_t, -sign(ja_t) * r.floss)
            else:
                quad = ja_t < 0
                f = where(quad, -materialize(r.D, ref) * ja_t, 0.0)
            force.append(f)
            quadw.append(where(quad, materialize(r.D, ref), 0.0))

        dx0 = [sub(x[d], qacc_smooth[d]) for d in range(s.nv)]
        ma = _sym_mv(s, M, dx0)
        grad = list(ma)
        for r, f in zip(rows, force):
            if r is box:
                grad = box.rows_and_grad(x, grad, jar_arr, D_arr, box_os0, ref)
                continue
            for d, jv in r.J.items():
                grad[d] = sub(grad[d], mul(jv, f))

        # Hessian on the row-coupling pattern s.hess
        H = {
            (j, k): M.get((j, k), 0.0)
            for j in range(s.nv)
            for k in range(j + 1)
            if s.hess[j, k]
        }
        for r, w in zip(rows, quadw):
            if r is box:
                H = box.hessian(H, jar_arr, D_arr, box_os0, ref)
                continue
            dofs = list(r.J.keys())
            for a_i, d1 in enumerate(dofs):
                for d2 in dofs[: a_i + 1]:
                    hi, lo = (d1, d2) if d1 >= d2 else (d2, d1)
                    H[(hi, lo)] = fma(H[(hi, lo)], mul(w, r.J[d1]), r.J[d2])
        dx = [neg(t) for t in _ldl_solve_dict(s, H, grad, pattern=s.hess)]

        # ---- exact line search (solver.py:97-139), one-sided rows stacked ----
        jv_rows = []
        for r in rows:
            if r is box:
                box.jv(dx, jv_arr, box_os0, ref)
                jv_rows.append(None)
                continue
            acc = 0.0
            for d, jval in r.J.items():
                acc = fma(acc, jval, dx[d])
            jv_rows.append(acc)
        mdx = _sym_mv(s, M, dx)
        g0 = functools.reduce(add, [mul(dx[d], ma[d]) for d in range(s.nv)])
        h0 = maximum(
            materialize(
                functools.reduce(add, [mul(dx[d], mdx[d]) for d in range(s.nv)]),
                ref,
            ),
            1e-12,
        )
        g0 = materialize(g0, ref)

        os_rows = [i for i, r in enumerate(rows) if r is not box and not r.fric]
        fr_rows = [i for i, r in enumerate(rows) if r is not box and r.fric]
        if box is None:
            jar_os = stack_rows([jar[i] for i in os_rows], ref)
            jv_os = stack_rows([jv_rows[i] for i in os_rows], ref)
            D_os = stack_rows([rows[i].D for i in os_rows], ref)
        else:
            for i in os_rows:
                array_store(jar_arr, materialize(jar[i], ref), os_at[i])
                array_store(jv_arr, materialize(jv_rows[i], ref), os_at[i])
                array_store(D_arr, materialize(rows[i].D, ref), os_at[i])
            jar_os, jv_os, D_os = (array_rows(a, ref) for a in (jar_arr, jv_arr, D_arr))
        jar_fr = [jar[i] for i in fr_rows]
        jv_fr = [jv_rows[i] for i in fr_rows]

        def dphi(alpha):
            acc = os_dphi(D_os, jar_os, jv_os, alpha)
            for i, (ja, jv) in enumerate(zip(jar_fr, jv_fr)):
                r = rows[fr_rows[i]]
                dja = mul(r.D, add(ja, mul(alpha, jv)))
                sval = clip(materialize(dja, ref), -r.floss, r.floss)
                acc = acc + sval * materialize(jv, ref)
            return g0 + alpha * h0 + acc

        def expand(i, carry):
            # grow until phi'(hi) > 0
            (hi,) = carry
            return [where(dphi(hi) <= 0, hi * 4.0, hi)]

        (hi,) = fori_loop(LS_EXPAND_ITERS, expand, [full_like(ref, 1.0)])
        lo = full_like(hi, 0.0)
        f_lo = dphi(lo)
        f_hi = dphi(hi)

        def illinois(i, carry):
            lo, f_lo, hi, f_hi, side = carry
            denom = f_hi - f_lo
            denom = where(abs_(denom) < 1e-30, 1e-30, denom)
            mid = hi - f_hi * (hi - lo) / denom
            mid = clip(mid, lo, hi)
            fm = dphi(mid)
            take_lo = fm <= 0  # root in [mid, hi]
            new_lo = where(take_lo, mid, lo)
            new_flo = where(take_lo, fm, f_lo)
            new_hi = where(take_lo, hi, mid)
            new_fhi = where(take_lo, f_hi, fm)
            # Illinois: same-side repeat halves the opposite f value
            rep_lo = take_lo & (side == 1)
            rep_hi = (~take_lo) & (side == -1)
            new_fhi = where(rep_lo, new_fhi * 0.5, new_fhi)
            new_flo = where(rep_hi, new_flo * 0.5, new_flo)
            new_side = where(take_lo, 1, -1)
            return [new_lo, new_flo, new_hi, new_fhi, new_side]

        lo, _, hi, _, _ = fori_loop(
            LS_ILLINOIS_ITERS, illinois, [lo, f_lo, hi, f_hi, int_zeros_like(hi)]
        )
        # final exact secant on the segment-local bracket
        f_lo = dphi(lo)
        f_hi = dphi(hi)
        slope = maximum((f_hi - f_lo) / maximum(hi - lo, 1e-30), 1e-12)
        alpha = maximum(lo - f_lo / slope, 0.0)

        x = [add(x[d], mul(alpha, dx[d])) for d in range(s.nv)]

    return x


# ---------------------------------------------------------------------------
# semi-implicit Euler (integrate.py semantics)
# ---------------------------------------------------------------------------


def _emit_integrate(s: _Static, q, v, qacc):
    dt = s.timestep
    v2 = [add(v[d], mul(dt, qacc[d])) for d in range(s.nv)]
    q2 = list(q)
    for j in range(s.njnt):
        qa, d = s.jnt_qposadr[j], s.jnt_dofadr[j]
        if s.jnt_type[j] == JNT_HINGE:
            q2[qa] = add(q[qa], mul(dt, v2[d]))
        else:  # free joint
            for i in range(3):
                q2[qa + i] = add(q[qa + i], mul(dt, v2[d + i]))
            # quat_integrate: body-frame omega exponential map
            om = [v2[d + 3], v2[d + 4], v2[d + 5]]
            norm = sqrt(vdot3(om, om))
            axis_den = where(norm < 1e-12, 1.0, norm)
            axis = [om[i] / axis_den for i in range(3)]
            half = 0.5 * norm * dt
            ch, sh = cos(half), sin(half)
            dq = [ch, axis[0] * sh, axis[1] * sh, axis[2] * sh]
            quat = [q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6]]
            out = qmul(quat, dq)
            on = rsqrt(
                add(
                    add(mul(out[0], out[0]), mul(out[1], out[1])),
                    add(mul(out[2], out[2]), mul(out[3], out[3])),
                )
            )
            for i in range(4):
                q2[qa + 3 + i] = mul(out[i], on)
    return q2, v2


@with_cse
def _emit_substeps(s: _Static, q, v, ctrl, dr, n_substeps: int,
                   phase_limit: Optional[str] = None, sink: bool = False):
    """All-but-last substeps as a loop of (forward + integrate), then the
    final forward. Returns (q, v, fw): the state BEFORE the final
    integrate and the last forward pass. ``phase_limit`` cuts every
    forward pass (``_emit_forward``); with ``sink`` and a cut, the loop
    carries the sum of every pass's sink, and ``fw["sink"]`` is the total."""
    ref = q[0]
    sink = sink and phase_limit is not None
    total = 0.0
    if n_substeps > 1:
        def body(_, carry):
            ql, vl = carry[: s.nq], carry[s.nq : s.nq + s.nv]
            fw = _emit_forward(s, ql, vl, ctrl, dr, phase_limit, sink)
            q2, v2 = _emit_integrate(s, ql, vl, fw["qacc"])
            acc = [add(carry[-1], fw["sink"])] if sink else []
            return [materialize(t, ref) for t in q2 + v2 + acc]

        carry = fori_loop(
            n_substeps - 1, body,
            [materialize(t, ref) for t in list(q) + list(v) + ([total] if sink else [])],
        )
        q, v = carry[: s.nq], carry[s.nq : s.nq + s.nv]
        total = carry[-1]

    fw = _emit_forward(s, q, v, ctrl, dr, phase_limit, sink)
    if sink:
        fw["sink"] = add(total, fw["sink"])
    return q, v, fw


def _link_velocities(s: _Static, fw):
    """World-frame per-link velocities from the forward caches: ang =
    cvel_ang, vel = cvel_lin + ang x (xpos - com_root), world dropped."""
    xd_ang, xd_vel = [], []
    for b in range(1, s.nbody):
        ang, lin = fw["cvel"][b]
        off = vsub3(fw["xpos"][b], fw["com_root"])
        xd_ang.append(ang)
        xd_vel.append(vadd3(lin, vcross3(ang, off)))
    return xd_ang, xd_vel


def _emit_caches(s: _Static, fw) -> List:
    """The last forward pass's caches as one flat list in ``s.cache_rows``
    order (world body dropped from xquat and the link velocities)."""
    ang_l, vel_l = _link_velocities(s, fw)
    con_dist, con_pos = list(fw["con_dist"]), list(fw["con_pos"])
    if fw.get("boxes") is not None:
        fw["boxes"].contacts(con_dist, con_pos)
    parts = {
        "qacc": list(fw["qacc"]),
        "xpos": [c for b in range(s.nbody) for c in fw["xpos"][b]],
        "xquat": [c for b in range(1, s.nbody) for c in fw["xquat"][b]],
        "xd_ang": [c for a in ang_l for c in a],
        "xd_vel": [c for vv in vel_l for c in vv],
        "site_xpos": [c for sxyz in fw["sites"] for c in sxyz],
        "qfrc_actuator": list(fw["qfrc_actuator"]),
        "con_dist": con_dist,
        "con_pos": [c for p3 in con_pos for c in p3],
    }
    out = []
    for name, (_, n) in s.cache_rows.items():
        assert len(parts[name]) == n, (name, len(parts[name]), n)
        out.extend(parts[name])
    return out


def indexed_dr_rows(s: _Static) -> List[int]:
    """The rows of the DR block that a box model's emission reads only at
    the box loop's index (``row_at``): the pair frictions of the pairs of
    every box but the first."""
    if s.boxes is None:
        return []
    bx, r0 = s.boxes, s.dr_rows["pair_mu"][0]
    nsph = len(bx.spheres)
    return [r0 + bx.first + i for i in range(nsph, bx.n * nsph)]


def dr_inputs(m: RobotModel, s: _Static, B: int, device=None) -> Dict[str, torch.Tensor]:
    """Per-env parameter rows ``name -> (B, n)`` float32 from the (possibly
    DR-batched) model leaves; unbatched leaves are broadcast over the env
    batch. Batched-ness is detected by rank, as in the JAX package."""

    def rows(x, unbatched_ndim, n):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if x.ndim == unbatched_ndim + 1:  # leading env axis present
            return x.reshape(x.shape[0], n)
        return x.reshape(n)[None].expand(B, n)

    gain = torch.as_tensor(m.actuator_gainprm, dtype=torch.float32, device=device)
    bias = torch.as_tensor(m.actuator_biasprm, dtype=torch.float32, device=device)
    out = {
        "mass": rows(m.body_mass, 1, s.nbody),
        "inertia": rows(m.body_inertia, 2, s.nbody * 3),
        "ipos": rows(m.body_ipos, 2, s.nbody * 3),
        "gain0": rows(gain[..., 0], 1, s.nu),
        "bias1": rows(bias[..., 1], 1, s.nu),
        "bias2": rows(bias[..., 2], 1, s.nu),
    }
    # per-pair combined slide friction = max of the two geoms
    fr = torch.as_tensor(m.geom_friction, dtype=torch.float32, device=device)
    gf = rows(fr[..., 0], 1, len(m.geom_bodyid))
    out["pair_mu"] = torch.stack(
        [torch.maximum(gf[:, pr.geom1], gf[:, pr.geom2]) for pr in s.pairs], dim=1
    )
    return out


def dr_rows_block(s: _Static, dr: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The (ndr, B) row-major block of the DR rows, in ``s.dr_rows`` order."""
    parts = [
        dr[name].reshape(dr[name].shape[0], n)
        for name, (r0, n) in sorted(s.dr_rows.items(), key=lambda kv: kv[1][0])
    ]
    return torch.cat(parts, dim=1).t().contiguous()


# ---------------------------------------------------------------------------
# the physics-only step (K1): the emission, its plain version, the kernel
# ---------------------------------------------------------------------------


def plain_rows(emit, blocks):
    """Evaluate an emission with torch ops on ``(rows, B)`` blocks; the
    outputs come back as ``(rows, B)`` blocks of the inputs' dtype."""
    rows = [[x[i] for i in range(x.shape[0])] for x in blocks]
    ref = rows[0][0]
    return tuple(torch.stack([materialize(x, ref) for x in o]) for o in emit(rows))


def physics_block_rows(s: _Static):
    """Row counts of K1's 4 input blocks (q, v, ctrl, dr) and 3 output
    blocks (q, v, caches)."""
    return (s.nq, s.nv, s.nu, s.ndr), (s.nq, s.nv, s.ncache)


@with_cse
def emit_physics_rows(s: _Static, n_substeps: int, rows, phase_limit: Optional[str] = None,
                      sink: bool = False):
    """The physics-only step on 4 lists of per-row values (either
    back-end): the substeps, the last forward pass's caches and the final
    integrate (``puppax/physics/soa.py::_build_kernel`` with integrate=True).
    Returns the 3 output lists in block order. ``phase_limit`` cuts every
    forward pass after that phase (``PHASES``), for the kernel-time probes;
    ``sink`` adds a fourth output of one row, the sum of what every cut
    pass computed (``_emit_forward``; 0 without a cut)."""
    q, v, ctrl, dr_r = rows
    dr = {name: [dr_r[r0 + i] for i in range(n)] for name, (r0, n) in s.dr_rows.items()}
    qp, vp, fw = _emit_substeps(s, q, v, ctrl, dr, n_substeps, phase_limit, sink)
    caches = _emit_caches(s, fw)
    q2, v2 = _emit_integrate(s, qp, vp, fw["qacc"])
    return (q2, v2, caches, [fw.get("sink", 0.0)]) if sink else (q2, v2, caches)


def physics_step_rows(s: _Static, n_substeps: int, q, v, ctrl, dr,
                      phase_limit: Optional[str] = None, sink: bool = False):
    """K1's plain version: the physics-only emission evaluated with torch
    ops on ``(rows, B)`` blocks (q, v, ctrl, dr). Returns (q', v', caches)
    as ``(rows, B)`` blocks, the caches in ``s.cache_rows`` order.
    ``phase_limit`` evaluates the emission cut after that phase, and
    ``sink`` adds its sink row (``emit_physics_rows``)."""
    return plain_rows(lambda rows: emit_physics_rows(s, n_substeps, rows, phase_limit, sink),
                      (q, v, ctrl, dr))


def _physics_step(wrapper, kernel: build.Kernel, library, s: _Static, blocks,
                  n_substeps: int):
    """The wrappers' body: the plain version on CPU tensors, else one launch
    of ``kernel`` from ``library(s, n_substeps)``, counted on ``wrapper``."""
    in_rows, out_rows = physics_block_rows(s)
    B, dev = build.check_blocks(in_rows, blocks)
    if dev.type == "cpu":
        return physics_step_rows(s, n_substeps, *blocks)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {dev}")
    lib = library(s, n_substeps)
    build.bind_scratch(lib, kernel, B, dev)
    outs = build.launch(kernel.name, getattr(lib, kernel.launch), blocks, out_rows, B, dev)
    wrapper.launches += 1
    return outs


def step_batched(s: _Static, q, v, ctrl, dr, n_substeps: int):
    """One physics-only env step (``n_substeps`` substeps) of every env over
    ``(rows, B)`` float32 blocks: q ``(nq, B)``, v ``(nv, B)``, ctrl
    ``(nu, B)``, dr ``(ndr, B)``. Returns (q', v', caches).

    CPU tensors run the plain version (``physics_step_rows``); CUDA tensors
    launch team K1 (``csrc/physics_step_team.cuh``: 32 envs per block, each
    env's program split across the block's warps) on the current stream, or
    raise. Each launch adds one to ``step_batched.launches``."""
    return _physics_step(step_batched, build.PHYSICS_STEP_TEAM, build.physics_step_team_library,
                         s, (q, v, ctrl, dr), n_substeps)


step_batched.launches = 0


def step_batched_one_thread(s: _Static, q, v, ctrl, dr, n_substeps: int):
    """``step_batched`` through the one-thread K1 (``csrc/physics_step.cuh``,
    one env per thread): the A/B baseline of ``chip_smoke.py`` and the
    probes. Each launch adds one to ``step_batched_one_thread.launches``."""
    return _physics_step(step_batched_one_thread, build.PHYSICS_STEP,
                         build.physics_step_library, s, (q, v, ctrl, dr), n_substeps)


step_batched_one_thread.launches = 0
