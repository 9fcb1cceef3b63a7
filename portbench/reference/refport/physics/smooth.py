"""Smooth (unconstrained) dynamics: FK, COM frames, CRB, RNE, actuation.

Counterpart of ``puppax/physics/smooth.py``: the MuJoCo stages
mj_kinematics, mj_comPos, mj_comVel, mj_crb, mj_rne and mj_fwdActuation
on the same level schedule (all bodies of one tree depth and joint kind
advanced by one batched op). The JAX functions act on one env and are
vmapped; these take state tensors with a leading env axis ``(B, ...)``.

Model leaves may be numpy arrays or tensors, unbatched or with a leading
env axis (the domain-randomized leaves); each is read with the state's
dtype and device (``leaf``), so a float64 state computes in float64.
Static index sets (levels, dof addresses) index directly: the one-hot
selections of ``puppax/ops/select.py`` exist only for the TPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from refport.model.mjcf import JNT_FREE, JNT_HINGE, RobotModel
from refport.ops import math


class Kinematics(NamedTuple):
    xpos: torch.Tensor  # (B, nbody, 3) body frame origins, world frame
    xquat: torch.Tensor  # (B, nbody, 4)
    xipos: torch.Tensor  # (B, nbody, 3) body COM positions
    ximat: torch.Tensor  # (B, nbody, 3, 3) inertial frame orientations
    xanchor: torch.Tensor  # (B, njnt, 3) joint anchors, world frame
    xaxis: torch.Tensor  # (B, njnt, 3) joint axes, world frame
    site_xpos: torch.Tensor  # (B, nsite, 3)
    geom_xpos: torch.Tensor  # (B, ngeom, 3)
    geom_xmat: torch.Tensor  # (B, ngeom, 3, 3)


class ComQuantities(NamedTuple):
    subtree_com: torch.Tensor  # (B, nbody, 3)
    cinert: torch.Tensor  # (B, nbody, 6, 6) spatial inertia about the root-subtree com
    cdof: torch.Tensor  # (B, nv, 6) dof motion axes about the root-subtree com


class Velocity(NamedTuple):
    cvel: torch.Tensor  # (B, nbody, 6) spatial velocities [ang; lin]
    cdof_dot: torch.Tensor  # (B, nv, 6)


class _Level(NamedTuple):
    kind: str  # 'free' | 'hinge' | 'fixed'
    bodies: tuple
    parents: tuple
    jnts: tuple  # joint ids (empty for 'fixed')


@functools.lru_cache(maxsize=None)
def _schedule(nbody, body_parentid, body_jntid, jnt_type):
    """Static level schedule: bodies grouped by tree depth and joint kind."""
    depth = [0] * nbody
    for i in range(1, nbody):
        depth[i] = depth[body_parentid[i]] + 1
    levels = []
    for d in range(1, max(depth) + 1 if nbody > 1 else 1):
        groups = {"free": [], "hinge": [], "fixed": []}
        for i in (i for i in range(1, nbody) if depth[i] == d):
            j = body_jntid[i]
            if j == -1:
                groups["fixed"].append(i)
            elif jnt_type[j] == JNT_FREE:
                groups["free"].append(i)
            elif jnt_type[j] == JNT_HINGE:
                groups["hinge"].append(i)
            else:  # pragma: no cover - refused when the tables are written
                raise NotImplementedError(jnt_type[j])
        for kind in ("free", "hinge", "fixed"):
            bs = groups[kind]
            if bs:
                levels.append(_Level(kind, tuple(bs), tuple(body_parentid[i] for i in bs),
                                     tuple(body_jntid[i] for i in bs)))
    return tuple(levels)


def _levels(m: RobotModel):
    return _schedule(m.nbody, m.body_parentid, m.body_jntid, m.jnt_type)


def leaf(m: RobotModel, name: str, ref: torch.Tensor) -> torch.Tensor:
    """The model leaf ``name`` as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(getattr(m, name), dtype=ref.dtype, device=ref.device)


def _index(idx, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(list(idx), dtype=torch.int64, device=ref.device)


def add_rows(x: torch.Tensor, idx, values: torch.Tensor) -> torch.Tensor:
    """x.at[:, idx].add(values) on axis 1, duplicates accumulating: the
    values are summed into zeros first and added once, as
    ``puppax.ops.select.add_rows`` does."""
    scatter = torch.zeros_like(x).index_add_(1, _index(idx, x), values)
    return x + scatter


def kinematics(m: RobotModel, qpos: torch.Tensor) -> Kinematics:
    """Forward kinematics of (B, nq) qpos, level-scheduled."""
    B = qpos.shape[0]
    body_pos, body_quat = leaf(m, "body_pos", qpos), leaf(m, "body_quat", qpos)
    jnt_axis, jnt_pos = leaf(m, "jnt_axis", qpos), leaf(m, "jnt_pos", qpos)
    qpos0 = leaf(m, "qpos0", qpos)
    xpos = qpos.new_zeros((B, m.nbody, 3))
    xquat = qpos.new_zeros((B, m.nbody, 4))
    xquat[:, 0, 0] = 1.0
    xanchor = qpos.new_zeros((B, m.njnt, 3))
    xaxis = qpos.new_zeros((B, m.njnt, 3))

    for lv in _levels(m):
        if lv.kind == "free":
            for body, j in zip(lv.bodies, lv.jnts):
                qadr = m.jnt_qposadr[j]
                pos = qpos[:, qadr : qadr + 3]
                quat = qpos[:, qadr + 3 : qadr + 7]
                quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
                xpos[:, body] = pos
                xquat[:, body] = quat
                xanchor[:, j] = pos
                xaxis[:, j] = jnt_axis[..., j, :]  # free axis unrotated
            continue
        bodies, parents = list(lv.bodies), list(lv.parents)
        pq = xquat[:, parents]
        frame_pos = xpos[:, parents] + math.rotate(body_pos[..., bodies, :], pq)
        frame_quat = math.quat_mul(pq, body_quat[..., bodies, :])
        if lv.kind == "fixed":
            xpos[:, bodies] = frame_pos
            xquat[:, bodies] = frame_quat
            continue
        jnts = list(lv.jnts)
        qadr = [m.jnt_qposadr[j] for j in jnts]
        angle = qpos[:, qadr] - qpos0[..., qadr]
        axis, jpos = jnt_axis[..., jnts, :], jnt_pos[..., jnts, :]
        half = 0.5 * angle
        qloc = torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], -1)
        quat = math.quat_mul(frame_quat, qloc)
        anchor = frame_pos + math.rotate(jpos, frame_quat)
        xpos[:, bodies] = anchor - math.rotate(jpos, quat)
        xquat[:, bodies] = quat
        xanchor[:, jnts] = anchor
        xaxis[:, jnts] = math.rotate(axis, quat)

    # inertial / site / geom frames: one batched op each
    xipos = xpos + math.rotate(leaf(m, "body_ipos", qpos), xquat)
    ximat = math.quat_to_mat(math.quat_mul(xquat, leaf(m, "body_iquat", qpos)))
    sb = list(m.site_bodyid)
    site_xpos = xpos[:, sb] + math.rotate(leaf(m, "site_pos", qpos), xquat[:, sb])
    gb = list(m.geom_bodyid)
    gq = xquat[:, gb]
    geom_xpos = xpos[:, gb] + math.rotate(leaf(m, "geom_pos", qpos), gq)
    geom_xmat = math.quat_to_mat(math.quat_mul(gq, leaf(m, "geom_quat", qpos)))
    return Kinematics(xpos, xquat, xipos, ximat, xanchor, xaxis, site_xpos, geom_xpos,
                      geom_xmat)


def com_pos(m: RobotModel, kin: Kinematics) -> ComQuantities:
    """Subtree COMs, com-frame spatial inertias and dof axes (mj_comPos)."""
    ref = kin.xpos
    B = ref.shape[0]
    mass = leaf(m, "body_mass", ref)
    subtree_mass = mass.expand(B, m.nbody)
    subtree_mom = mass[..., None] * kin.xipos
    for lv in reversed(_levels(m)):
        bodies = list(lv.bodies)
        subtree_mass = add_rows(subtree_mass, lv.parents, subtree_mass[:, bodies])
        subtree_mom = add_rows(subtree_mom, lv.parents, subtree_mom[:, bodies])
    subtree_com = subtree_mom / torch.clamp_min(subtree_mass, 1e-12)[..., None]

    # spatial inertia of each body about its kinematic-tree-root com
    offset = kin.xipos - subtree_com[:, list(m.body_rootid)]
    cinert = math.transform_inertia(mass, leaf(m, "body_inertia", ref), offset, kin.ximat)

    cdof = ref.new_zeros((B, m.nv, 6))
    hinge_j = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_HINGE]
    if hinge_j:
        dadr = [m.jnt_dofadr[j] for j in hinge_j]
        roots = [m.body_rootid[m.jnt_bodyid[j]] for j in hinge_j]
        ax = kin.xaxis[:, hinge_j]
        off = subtree_com[:, roots] - kin.xanchor[:, hinge_j]
        cdof[:, dadr] = torch.cat([ax, torch.linalg.cross(ax, off)], -1)
    for j in range(m.njnt):
        if m.jnt_type[j] != JNT_FREE:
            continue
        b, d = m.jnt_bodyid[j], m.jnt_dofadr[j]
        com_r = subtree_com[:, m.body_rootid[b]]
        cdof[:, d : d + 3, 3:] = torch.eye(3, dtype=ref.dtype, device=ref.device)
        axes = math.quat_to_mat(kin.xquat[:, b]).transpose(-1, -2)  # rows = body axes
        off = (com_r - kin.xanchor[:, j])[:, None, :]
        cdof[:, d + 3 : d + 6] = torch.cat([axes, torch.linalg.cross(axes, off.expand_as(axes))],
                                           -1)
    return ComQuantities(subtree_com, cinert, cdof)


def com_vel(m: RobotModel, com: ComQuantities, qvel: torch.Tensor) -> Velocity:
    """Body spatial velocities and dof-axis derivatives (mj_comVel)."""
    B = qvel.shape[0]
    cvel = qvel.new_zeros((B, m.nbody, 6))
    cdof_dot = qvel.new_zeros((B, m.nv, 6))
    for lv in _levels(m):
        bodies = list(lv.bodies)
        v_parent = cvel[:, list(lv.parents)]
        if lv.kind == "fixed":
            cvel[:, bodies] = v_parent
            continue
        if lv.kind == "hinge":
            dadr = [m.jnt_dofadr[j] for j in lv.jnts]
            cd = com.cdof[:, dadr]
            cdof_dot[:, dadr] = math.motion_cross(v_parent, cd)
            cvel[:, bodies] = v_parent + cd * qvel[:, dadr][..., None]
            continue
        for body, j in zip(lv.bodies, lv.jnts):  # free joints
            d = m.jnt_dofadr[j]
            v = cvel[:, m.body_parentid[body]]
            v_trans = v + torch.sum(com.cdof[:, d : d + 3] * qvel[:, d : d + 3, None], 1)
            rot = com.cdof[:, d + 3 : d + 6]
            cdof_dot[:, d + 3 : d + 6] = math.motion_cross(v_trans[:, None, :].expand_as(rot), rot)
            cvel[:, body] = v_trans + torch.sum(rot * qvel[:, d + 3 : d + 6, None], 1)
    return Velocity(cvel, cdof_dot)


@functools.lru_cache(maxsize=None)
def _crb_masks(nbody, nv, body_parentid, jnt_type, jnt_dofadr, jnt_bodyid, njnt):
    """Static CRB masks: per-dof body index and the lower-triangular
    ancestor-pair mask anc[j, k] = 1 iff dof k is an ancestor-or-self dof
    of dof j's body and k <= j."""
    body_dofs = [[] for _ in range(nbody)]
    dof_body = np.zeros(nv, dtype=np.int64)
    for j in range(njnt):
        b, d = jnt_bodyid[j], jnt_dofadr[j]
        for dd in range(d, d + (6 if jnt_type[j] == JNT_FREE else 1)):
            body_dofs[b].append(dd)
            dof_body[dd] = b
    chains = [[] for _ in range(nbody)]
    for i in range(1, nbody):
        chains[i] = chains[body_parentid[i]] + body_dofs[i]
    anc = np.zeros((nv, nv), dtype=np.float64)
    for jd in range(nv):
        for kd in chains[dof_body[jd]]:
            if kd <= jd:
                anc[jd, kd] = 1.0
    return tuple(dof_body.tolist()), anc


def _live_pairs(lv: _Level):
    """(children, parents) of a level whose parent is not the world body
    (contributions into the world body are dropped)."""
    live = [(b, p) for b, p in zip(lv.bodies, lv.parents) if p > 0]
    return [b for b, _ in live], [p for _, p in live]


def crb(m: RobotModel, com: ComQuantities) -> torch.Tensor:
    """(B, nv, nv) joint-space inertia by composite rigid bodies (mj_crb):
    F[j] = crb_inertia[body(j)] cdof[j]; lower triangle anc * (F cdof^T),
    symmetrized, plus the armature."""
    ref = com.cdof
    crb_inert = com.cinert
    for lv in reversed(_levels(m)):
        bs, ps = _live_pairs(lv)
        if bs:
            crb_inert = add_rows(crb_inert, ps, crb_inert[:, bs])
    dof_body, anc = _crb_masks(m.nbody, m.nv, m.body_parentid, m.jnt_type, m.jnt_dofadr,
                               m.jnt_bodyid, m.njnt)
    F = torch.sum(crb_inert[:, list(dof_body)] * com.cdof[:, :, None, :], -1)
    W = torch.sum(F[:, :, None, :] * com.cdof[:, None, :, :], -1)
    W = W * torch.as_tensor(anc, dtype=ref.dtype, device=ref.device)
    return (W + W.transpose(-1, -2) - torch.diag_embed(torch.diagonal(W, dim1=-2, dim2=-1))
            + torch.diag_embed(leaf(m, "dof_armature", ref)))


def rne(m: RobotModel, com: ComQuantities, vel: Velocity, qvel: torch.Tensor) -> torch.Tensor:
    """(B, nv) bias forces C(q, qvel) including gravity (mj_rne, flg_acc=0)."""
    B = qvel.shape[0]
    cacc = qvel.new_zeros((B, m.nbody, 6))
    cacc[:, 0, 3:] = -leaf(m, "gravity", qvel)
    for lv in _levels(m):
        a = cacc[:, list(lv.parents)]
        if lv.kind == "hinge":
            dadr = [m.jnt_dofadr[j] for j in lv.jnts]
            a = a + vel.cdof_dot[:, dadr] * qvel[:, dadr][..., None]
        elif lv.kind == "free":
            for i, j in enumerate(lv.jnts):
                d = m.jnt_dofadr[j]
                extra = torch.sum(vel.cdof_dot[:, d : d + 6] * qvel[:, d : d + 6, None], 1)
                a = add_rows(a, (i,), extra[:, None])
        cacc[:, list(lv.bodies)] = a

    # per-body forces: I a + v x* (I v), batched over all bodies
    Iv = torch.sum(com.cinert * vel.cvel[:, :, None, :], -1)
    Ia = torch.sum(com.cinert * cacc[:, :, None, :], -1)
    total = Ia + math.motion_cross_force(vel.cvel, Iv)
    for lv in reversed(_levels(m)):
        bs, ps = _live_pairs(lv)
        if bs:
            total = add_rows(total, ps, total[:, bs])

    qfrc_bias = qvel.new_zeros((B, m.nv))
    hinge_j = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_HINGE]
    if hinge_j:
        dadr = [m.jnt_dofadr[j] for j in hinge_j]
        bb = [m.jnt_bodyid[j] for j in hinge_j]
        qfrc_bias[:, dadr] = torch.sum(com.cdof[:, dadr] * total[:, bb], -1)
    for j in range(m.njnt):
        if m.jnt_type[j] != JNT_FREE:
            continue
        d, b = m.jnt_dofadr[j], m.jnt_bodyid[j]
        qfrc_bias[:, d : d + 6] = torch.sum(com.cdof[:, d : d + 6] * total[:, b, None, :], -1)
    return qfrc_bias


def passive(m: RobotModel, qvel: torch.Tensor) -> torch.Tensor:
    """Passive joint damping force (frictionloss is a solver constraint)."""
    return -leaf(m, "dof_damping", qvel) * qvel


def actuation(m: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor,
              ctrl: torch.Tensor) -> torch.Tensor:
    """(B, nv) affine actuator force gain*ctrl + bias.[1, q, qd], clipped to
    the force range: the PD servo kp (ctrl - q) - kd qd."""
    qadr = [m.jnt_qposadr[j] for j in m.actuator_jntid]
    dadr = [m.jnt_dofadr[j] for j in m.actuator_jntid]
    bias_p, gain_p = leaf(m, "actuator_biasprm", qpos), leaf(m, "actuator_gainprm", qpos)
    frange = leaf(m, "actuator_forcerange", qpos)
    bias = bias_p[..., 0] + bias_p[..., 1] * qpos[:, qadr] + bias_p[..., 2] * qvel[:, dadr]
    force = gain_p[..., 0] * ctrl + bias
    force = torch.minimum(torch.maximum(force, frange[..., 0]), frange[..., 1])
    return add_rows(qpos.new_zeros((qpos.shape[0], m.nv)), dadr, force)
