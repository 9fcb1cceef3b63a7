"""The physics model's static digest for the env's row layouts.

Counterpart of the static part of ``puppax/physics/soa.py``: ``_Static``
(the model's tree, contact pairs and box table as host constants), the
kernels' class (``soa_supported``) and the per-env DR parameter rows
(``dr_inputs``, ``dr_rows_block``). The emission of the physics program,
which the kernels are built from, is left out: the reference's physics is
``pipeline.pipeline_step`` (``smooth``, ``collision``, ``constraint``,
``solver``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from refport.model.mjcf import JNT_FREE, JNT_HINGE, MjTables, RobotModel

_MINVAL = 1e-15


# the largest heightfield grid the emitter takes (puppax/physics/soa.py's
# bound; here the grid is a table the kernel reads, 4 bytes a cell)
MAX_HFIELD_CELLS = 4096


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


def _impedance_constants(solimp: tuple) -> tuple:
    """(dmin, dmax - dmin, width, mid, a, b): the constants the impedance
    of a value folds in, as Python floats."""
    dmin, dmax, width, mid, power = (float(x) for x in solimp)
    return (dmin, dmax - dmin, max(width, _MINVAL), mid,
            1.0 / max(mid, _MINVAL) ** (power - 1.0),
            1.0 / max(1.0 - mid, _MINVAL) ** (power - 1.0))


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
