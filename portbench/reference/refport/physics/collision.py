"""Analytic narrowphase with the MJX contact caps.

Counterpart of ``puppax/physics/collision.py`` for its seven pair kinds:
plane-sphere, sphere-sphere, sphere-box (obstacle terrain), hfield-sphere
(heightfield terrain), plane-capsule (two contacts a pair, one per capsule
end), sphere-capsule and capsule-capsule (capsule-legged models). Every
candidate pair is evaluated each step with fixed shapes. ``collide``
applies the MJX caps the solver sees (``max_geom_pairs`` per pair kind, then
``max_contact_points`` overall, each a top-k by penetration depth);
``collide_pairs`` is the uncapped report in static pair order that the
env's rewards read.

Contact conventions are MuJoCo's: ``dist`` < 0 is penetration, the frame's
first row is the normal from geom1 into geom2, ``pos`` is the midpoint of
the overlap; friction is the elementwise max and solref/solimp the mean of
the two geoms. Every field has a leading env axis ``(B, ncon, ...)``; the
geom and body ids are int64 (per env, since the caps select per env).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from refport.model.mjcf import RobotModel
from refport.physics.smooth import Kinematics, leaf

_PAD_DIST = 1e10


class Contacts(NamedTuple):
    """Fixed-size contact set, batched over envs."""

    dist: torch.Tensor  # (B, ncon) penetration (<0), or large positive for pads
    pos: torch.Tensor  # (B, ncon, 3)
    frame: torch.Tensor  # (B, ncon, 3, 3) rows = [normal, tangent1, tangent2]
    friction: torch.Tensor  # (B, ncon, 2) tangential friction coefficients
    solref: torch.Tensor  # (B, ncon, 2)
    solimp: torch.Tensor  # (B, ncon, 5)
    invweight: torch.Tensor  # (B, ncon) body_invweight0 lin sum of the two bodies
    geom1: torch.Tensor  # (B, ncon) int64
    geom2: torch.Tensor  # (B, ncon)
    body1: torch.Tensor  # (B, ncon)
    body2: torch.Tensor  # (B, ncon)


def _make_frames(n: torch.Tensor) -> torch.Tensor:
    """Contact frames from unit normals (..., 3), mju_makeFrame: helper
    axis e = y if |n_y| < 0.5 else z; t2 = normalize(n x e); t1 = t2 x n."""
    ey = n.new_tensor([0.0, 1.0, 0.0])
    ez = n.new_tensor([0.0, 0.0, 1.0])
    e = torch.where((torch.abs(n[..., 1]) < 0.5)[..., None], ey, ez)
    t2 = torch.linalg.cross(n, e)
    t2 = t2 / torch.clamp_min(torch.linalg.vector_norm(t2, dim=-1, keepdim=True), 1e-12)
    t1 = torch.linalg.cross(t2, n)
    return torch.stack([n, t1, t2], dim=-2)


def _combine(m: RobotModel, g1: np.ndarray, g2: np.ndarray, ref: torch.Tensor):
    """Per-contact parameters of static pairs (g1, g2): friction = max,
    solref/solimp = mean; both tangential directions use the slide
    coefficient. Returns (B, k, ...) tensors and the body ids."""
    B = ref.shape[0]
    k = len(g1)
    gf = leaf(m, "geom_friction", ref)
    fr = torch.maximum(gf[..., g1, 0], gf[..., g2, 0]).expand(B, k)
    tangential = torch.stack([fr, fr], dim=-1)
    sref, simp = leaf(m, "geom_solref", ref), leaf(m, "geom_solimp", ref)
    solref = (0.5 * (sref[..., g1, :] + sref[..., g2, :])).expand(B, k, 2)
    solimp = (0.5 * (simp[..., g1, :] + simp[..., g2, :])).expand(B, k, 5)
    bodyid = np.asarray(m.geom_bodyid)
    b1, b2 = bodyid[g1], bodyid[g2]
    iw = leaf(m, "body_invweight0", ref)[..., 0]
    invweight = (iw[..., b1] + iw[..., b2]).expand(B, k)
    return tangential, solref, solimp, invweight, b1, b2


def _plane_sphere(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched plane(g1)-sphere(g2) for static index arrays g1, g2."""
    n = kin.geom_xmat[:, g1, :, 2]  # plane normals = local z axes
    plane_pos = kin.geom_xpos[:, g1]
    center = kin.geom_xpos[:, g2]
    r = leaf(m, "geom_size", kin.xpos)[..., g2, 0]
    dist = torch.sum(n * (center - plane_pos), -1) - r
    pos = center - n * (r + 0.5 * dist)[..., None]
    return dist, pos, _make_frames(n)


def _sphere_sphere(m: RobotModel, kin: Kinematics, g1, g2):
    c1, c2 = kin.geom_xpos[:, g1], kin.geom_xpos[:, g2]
    size = leaf(m, "geom_size", kin.xpos)
    r1, r2 = size[..., g1, 0], size[..., g2, 0]
    delta = c2 - c1
    length = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / torch.clamp_min(length, 1e-12)[..., None]
    dist = length - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, _make_frames(n)


def _sphere_box(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched sphere(g1) vs box(g2); the normal points from the sphere
    into the box. Outside the box: the nearest surface point (the center
    clamped to the box). Inside: out through the nearest face (the first
    on a tie, as ``argmin``; a center on the face's plane goes out on the
    + side)."""
    ref = kin.xpos
    center = kin.geom_xpos[:, g1]
    size = leaf(m, "geom_size", ref)
    r = size[..., g1, 0]
    box_pos, box_mat = kin.geom_xpos[:, g2], kin.geom_xmat[:, g2]
    half = size[..., g2, :].expand(center.shape)
    # sphere centers in the box frames: p = R^T (c - box_pos)
    p = torch.einsum("bkij,bki->bkj", box_mat, center - box_pos)
    clamped = torch.minimum(torch.maximum(p, -half), half)
    inside = torch.all(torch.abs(p) < half, dim=-1)
    delta_out = p - clamped
    dist_out = torch.linalg.vector_norm(delta_out, dim=-1)
    n_out = -delta_out / torch.clamp_min(dist_out, 1e-12)[..., None]
    gaps = half - torch.abs(p)
    oh = torch.nn.functional.one_hot(torch.argmin(gaps, dim=-1), 3).to(p.dtype)
    sign = torch.sign(torch.sum(p * oh, dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    n_in = -sign[..., None] * oh
    dist_in = -torch.sum(gaps * oh, dim=-1)
    surf_in = p * (1.0 - oh) + oh * sign[..., None] * half
    dist = torch.where(inside, dist_in, dist_out) - r
    n_local = torch.where(inside[..., None], n_in, n_out)
    surf_local = torch.where(inside[..., None], surf_in, clamped)
    n = torch.einsum("bkij,bkj->bki", box_mat, n_local)
    surface = box_pos + torch.einsum("bkij,bkj->bki", box_mat, surf_local)
    pos = 0.5 * (center + n * r[..., None] + surface)
    return dist, pos, _make_frames(n)


def _hfield_sphere(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched heightfield(g1) vs sphere(g2): the tangent plane of the
    bilinear patch under the sphere's footprint. The four corner
    elevations are picked by indexing the grid (the JAX package folds
    one-hot masks over it, a TPU device; both pick the same values). A
    footprint outside the grid gives a separated row (``_PAD_DIST``)."""
    ref = kin.xpos
    H = leaf(m, "hfield_data", ref)  # (nrow, ncol), row 0 at y = -ry
    nrow, ncol = m.hfield_nrow, m.hfield_ncol
    rx, ry, ez = (float(x) for x in np.asarray(m.hfield_size).reshape(-1)[:3])
    hf_pos, hf_mat = kin.geom_xpos[:, g1], kin.geom_xmat[:, g1]
    center = kin.geom_xpos[:, g2]
    r = leaf(m, "geom_size", ref)[..., g2, 0]
    # sphere centers in the heightfield frame: p = R^T (c - hf_pos)
    p = torch.einsum("bkij,bki->bkj", hf_mat, center - hf_pos)
    u = (p[..., 0] + rx) / (2.0 * rx) * (ncol - 1)
    v = (p[..., 1] + ry) / (2.0 * ry) * (nrow - 1)
    outside = (torch.abs(p[..., 0]) > rx) | (torch.abs(p[..., 1]) > ry)
    iu = torch.clamp(torch.floor(u), 0.0, float(ncol - 2))
    iv = torch.clamp(torch.floor(v), 0.0, float(nrow - 2))
    fu = torch.clamp(u - iu, 0.0, 1.0)
    fv = torch.clamp(v - iv, 0.0, 1.0)
    ju = iu.long().clamp(0, ncol - 2)  # a NaN footprint picks a cell all the same
    jv = iv.long().clamp(0, nrow - 2)
    c00, c01 = H[jv, ju], H[jv, ju + 1]
    c10, c11 = H[jv + 1, ju], H[jv + 1, ju + 1]
    gu, gv = 1.0 - fu, 1.0 - fv
    h = ez * (gv * (gu * c00 + fu * c01) + fv * (gu * c10 + fu * c11))
    dhdx = ez * (gv * (c01 - c00) + fv * (c11 - c10)) * ((ncol - 1) / (2.0 * rx))
    dhdy = ez * (gu * (c10 - c00) + fu * (c11 - c01)) * ((nrow - 1) / (2.0 * ry))
    n_local = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], -1)
    n_local = n_local / torch.linalg.vector_norm(n_local, dim=-1, keepdim=True)
    dist = (p[..., 2] - h) * n_local[..., 2] - r
    dist = torch.where(outside, torch.full_like(dist, _PAD_DIST), dist)
    n = torch.einsum("bkij,bkj->bki", hf_mat, n_local)
    safe = torch.where(outside, torch.zeros_like(dist), dist)
    pos = center - n * (r + 0.5 * safe)[..., None]
    return dist, pos, _make_frames(n)


def _capsule_ends(m: RobotModel, kin: Kinematics, g):
    """The end centers and the radius of the capsules ``g`` (static ids):
    the center -/+ the local z axis times the half-length."""
    center = kin.geom_xpos[:, g]
    axis = kin.geom_xmat[:, g, :, 2]
    size = leaf(m, "geom_size", kin.xpos)
    r, half = size[..., g, 0], size[..., g, 1]
    return center - axis * half[..., None], center + axis * half[..., None], r


def _plane_capsule(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched plane(g1)-capsule(g2): one plane-sphere contact per capsule
    end, the rows interleaved [pair0_end0, pair0_end1, pair1_end0, ...].
    The first tangent is the capsule axis projected onto the plane
    (mjc_PlaneCapsule), or mju_makeFrame's below a norm of 1e-8 (a capsule
    normal to the plane); both are computed and one is selected."""
    n = kin.geom_xmat[:, g1, :, 2]
    plane_pos = kin.geom_xpos[:, g1]
    axis = kin.geom_xmat[:, g2, :, 2]
    e0, e1, r = _capsule_ends(m, kin, g2)
    ends = torch.stack([e0, e1], dim=2)  # (B, k, 2, 3)
    dist = torch.sum(n[..., None, :] * (ends - plane_pos[..., None, :]), -1) - r[..., None]
    pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
    B, k = dist.shape[:2]
    proj = axis - n * torch.sum(n * axis, -1, keepdim=True)
    pnorm = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
    fallback = _make_frames(n)
    t1 = torch.where(pnorm > 1e-8, proj / torch.clamp_min(pnorm, 1e-12), fallback[..., 1, :])
    t2 = torch.linalg.cross(n, t1)
    frames = torch.stack([n, t1, t2], dim=-2)
    return (dist.reshape(B, 2 * k), pos.reshape(B, 2 * k, 3),
            torch.repeat_interleave(frames, 2, dim=1))


def _sphere_capsule(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched sphere(g1)-capsule(g2): the sphere against the nearest point
    of the capsule's axis segment (mjc_SphereCapsule)."""
    c1 = kin.geom_xpos[:, g1]
    size = leaf(m, "geom_size", kin.xpos)
    r1 = size[..., g1, 0]
    center = kin.geom_xpos[:, g2]
    axis = kin.geom_xmat[:, g2, :, 2]
    r2, half = size[..., g2, 0], size[..., g2, 1]
    t = torch.minimum(torch.maximum(torch.sum((c1 - center) * axis, -1), -half), half)
    nearest = center + axis * t[..., None]
    delta = nearest - c1
    length = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / torch.clamp_min(length, 1e-12)[..., None]
    dist = length - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, _make_frames(n)


def _capsule_capsule(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched capsule-capsule: the closest points of the two axis segments
    (Ericson 5.1.9, clamped; s recomputed where t was clamped), then the
    sphere-sphere contact of those points (mjc_CapsuleCapsule)."""
    a0, a1, r1 = _capsule_ends(m, kin, g1)
    b0, b1, r2 = _capsule_ends(m, kin, g2)
    d1, d2, r_ = a1 - a0, b1 - b0, a0 - b0
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    f = torch.sum(d2 * r_, -1)
    c = torch.sum(d1 * r_, -1)
    b = torch.sum(d1 * d2, -1)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    torch.clamp((b * f - c * e) / torch.clamp_min(denom, 1e-12), 0.0, 1.0),
                    torch.zeros_like(denom))
    t = (b * s + f) / torch.clamp_min(e, 1e-12)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(t != t_cl,
                    torch.clamp((b * t_cl - c) / torch.clamp_min(a, 1e-12), 0.0, 1.0), s)
    p1 = a0 + d1 * s[..., None]
    p2 = b0 + d2 * t_cl[..., None]
    delta = p2 - p1
    length = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / torch.clamp_min(length, 1e-12)[..., None]
    dist = length - (r1 + r2)
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, _make_frames(n)


def _top_k_select(items, k: int):
    """Keep the k most-penetrating rows per env (ascending dist, first
    index on ties, as lax.top_k(-dist) orders them): k sequential argmins,
    each picked row masked with +inf so it cannot be picked again."""
    dist = items[0]
    n = dist.shape[1]
    if n <= k:
        return items
    masked = dist
    picks = []
    for _ in range(k):
        i = torch.argmin(masked, dim=1)
        picks.append(i)
        masked = masked.scatter(1, i[:, None], float("inf"))
    idx = torch.stack(picks, dim=1)  # (B, k)
    out = []
    for x in items:
        gather = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand((-1, -1) + x.shape[2:])
        out.append(torch.gather(x, 1, gather))
    return tuple(out)


def _pair_groups(m: RobotModel, kin: Kinematics):
    """Evaluate every candidate pair; yields one contact tuple per kind, in
    the JAX package's kind order. A plane-capsule pair yields two rows, its
    ids repeated."""
    B = kin.xpos.shape[0]
    dev = kin.xpos.device
    for pairs, fn, rows in ((m.pairs_plane_sphere, _plane_sphere, 1),
                            (m.pairs_sphere_sphere, _sphere_sphere, 1),
                            (m.pairs_sphere_box, _sphere_box, 1),
                            (m.pairs_hfield_sphere, _hfield_sphere, 1),
                            (m.pairs_plane_capsule, _plane_capsule, 2),
                            (m.pairs_sphere_capsule, _sphere_capsule, 1),
                            (m.pairs_capsule_capsule, _capsule_capsule, 1)):
        if not pairs:
            continue
        g1 = np.asarray([p[0] for p in pairs], np.int64)
        g2 = np.asarray([p[1] for p in pairs], np.int64)
        dist, pos, frame = fn(m, kin, g1, g2)
        g1, g2 = np.repeat(g1, rows), np.repeat(g2, rows)
        fri, sref, simp, iw, b1, b2 = _combine(m, g1, g2, kin.xpos)

        def ids(x):
            return torch.as_tensor(x, dtype=torch.int64, device=dev).expand(B, len(x))

        yield (dist, pos, frame, fri, sref, simp, iw, ids(g1), ids(g2), ids(b1), ids(b2))


def _merge(groups):
    return tuple(torch.cat([g[i] for g in groups], dim=1) for i in range(len(groups[0])))


def _empty_contacts(ref: torch.Tensor, ncon: int) -> Contacts:
    B = ref.shape[0]

    def full(shape, values):
        return ref.new_tensor(values).expand((B, ncon) + shape).clone()

    ints = torch.zeros((B, ncon), dtype=torch.int64, device=ref.device)
    return Contacts(
        dist=ref.new_full((B, ncon), _PAD_DIST), pos=ref.new_zeros((B, ncon, 3)),
        frame=full((3, 3), np.eye(3).tolist()), friction=ref.new_ones((B, ncon, 2)),
        solref=full((2,), [0.02, 1.0]), solimp=full((5,), [0.9, 0.95, 0.001, 0.5, 2.0]),
        invweight=ref.new_zeros((B, ncon)), geom1=ints, geom2=ints.clone(),
        body1=ints.clone(), body2=ints.clone(),
    )


def collide_pairs(m: RobotModel, kin: Kinematics) -> Contacts:
    """The uncapped per-pair contact set in static pair order: the
    reporting surface the env's collision rewards read. The solver uses
    the capped set of ``collide``; the two differ once more than
    ``max_geom_pairs`` pairs of one kind (or ``max_contact_points`` in all)
    penetrate."""
    groups = list(_pair_groups(m, kin))
    if not groups:
        return _empty_contacts(kin.xpos, 0)
    return Contacts(*_merge(groups))


def collide(m: RobotModel, kin: Kinematics) -> Contacts:
    """Evaluate all candidate pairs, then apply the per-kind and global
    top-k caps; pad to ``max_contact_points`` with separated rows."""
    groups = [_top_k_select(g, m.max_geom_pairs) for g in _pair_groups(m, kin)]
    ncon = m.max_contact_points
    if not groups:
        return _empty_contacts(kin.xpos, ncon)
    merged = _merge(groups)
    n_all = merged[0].shape[1]
    if n_all > ncon:
        merged = _top_k_select(merged, ncon)
    elif n_all < ncon:  # pads: far apart, identity frames, ones elsewhere
        pad = ncon - n_all
        fills = [
            x.new_full((x.shape[0], pad), _PAD_DIST) if i == 0
            else torch.zeros((x.shape[0], pad), dtype=x.dtype, device=x.device) if i >= 7
            else torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], pad, 3, 3)
            if i == 2 else x.new_ones((x.shape[0], pad) + x.shape[2:])
            for i, x in enumerate(merged)
        ]
        merged = tuple(torch.cat([x, f], dim=1) for x, f in zip(merged, fills))
    return Contacts(*merged)
