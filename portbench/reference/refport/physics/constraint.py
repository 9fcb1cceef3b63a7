"""Constraint (efc) row assembly: dof friction loss, joint limits, contacts.

Counterpart of ``puppax/physics/constraint.py``: the fixed-shape
constraint system the Newton solver consumes, batched over envs. Jacobian
J (B, nefc, nv), reference acceleration aref, inverse impedance D and R,
friction-loss bounds and row kinds, with MuJoCo's formulas:

  impedance d(pos):  smoothstep of |pos|/width between dmin and dmax
  K = 1 / (dmax^2 timeconst^2 dampratio^2),  B = 2 / (dmax timeconst)
  aref = -d K pos - B (J qvel)
  R = max((1 - d) / d, MINVAL) r,  D = 1 / R
    r of friction-loss and limit rows = dof_invweight0[dof]
    r of a pyramid facet              = (iw1 + iw2) 2 mu^2 (1 + mu^2) / impratio

Contacts use the pyramidal cone (4 facets each, n +- mu t). Every row
always exists; rows MuJoCo would not instantiate (separated contacts,
limits not violated) are masked by D = 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from refport.model.mjcf import JNT_FREE, RobotModel
from refport.physics.collision import Contacts
from refport.physics.smooth import ComQuantities, leaf

_MINVAL = 1e-15


class EfcData(NamedTuple):
    J: torch.Tensor  # (B, nefc, nv)
    aref: torch.Tensor  # (B, nefc)
    D: torch.Tensor  # (B, nefc)
    R: torch.Tensor  # (B, nefc)
    floss: torch.Tensor  # (B, nefc) friction-loss bound (0 on other rows)
    is_friction: torch.Tensor  # (nefc,) bool
    pos: torch.Tensor  # (B, nefc) constraint position


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo constraint impedance d(pos), clipped to [1e-4, 0.9999]."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(pos) / torch.clamp_min(width, _MINVAL), 0.0, 1.0)
    a = 1.0 / torch.pow(torch.clamp_min(mid, _MINVAL), power - 1.0)
    b = 1.0 / torch.pow(torch.clamp_min(1.0 - mid, _MINVAL), power - 1.0)
    y_lo = a * torch.pow(x, power)
    y_hi = 1.0 - b * torch.pow(1.0 - x, power)
    y = torch.where(x < mid, y_lo, y_hi)
    return torch.clamp(dmin + y * (dmax - dmin), 1e-4, 0.9999)


def _kb(solref: torch.Tensor, solimp: torch.Tensor):
    """Stiffness K and damping B from solref (standard and direct forms)."""
    dmax = solimp[..., 1]
    timeconst, dampratio = solref[..., 0], solref[..., 1]
    k_std = 1.0 / torch.clamp_min(dmax * dmax * timeconst * timeconst * dampratio * dampratio,
                                  _MINVAL)
    b_std = 2.0 / torch.clamp_min(dmax * timeconst, _MINVAL)
    k_dir = -solref[..., 0] / torch.clamp_min(dmax * dmax, _MINVAL)
    b_dir = -solref[..., 1] / torch.clamp_min(dmax, _MINVAL)
    direct = (solref[..., 0] <= 0) | (solref[..., 1] <= 0)
    return torch.where(direct, k_dir, k_std), torch.where(direct, b_dir, b_std)


def _row(solref, solimp, pos, jvel, r_scale, enable=None):
    """Per-row (aref, D, R); ``enable`` False masks the row by D = 0."""
    d = impedance(solimp, pos)
    K, Bd = _kb(solref, solimp)
    aref = -d * K * pos - Bd * jvel
    R = torch.clamp_min((1.0 - d) / torch.clamp_min(d, _MINVAL), _MINVAL) * r_scale
    R = torch.clamp_min(R, _MINVAL)
    D = 1.0 / R
    if enable is not None:
        D = torch.where(enable, D, torch.zeros_like(D))
    return aref, D, R


@functools.lru_cache(maxsize=None)
def _static_tables(nbody, nv, njnt, body_parentid, jnt_bodyid, jnt_dofadr, jnt_type,
                   dof_frictional, jnt_limited, jnt_qposadr):
    """Host-side index tables: the per-body ancestor-dof mask, the
    friction-loss dofs and one-hot rows, the limited joints with their
    qpos/dof addresses and one-hot rows."""
    body_dofs = [[] for _ in range(nbody)]
    for j in range(njnt):
        d0 = jnt_dofadr[j]
        body_dofs[jnt_bodyid[j]].extend(range(d0, d0 + (6 if jnt_type[j] == JNT_FREE else 1)))
    mask = np.zeros((nbody, nv), dtype=np.float64)
    for i in range(1, nbody):
        b = i
        while b != 0:
            for dof in body_dofs[b]:
                mask[i, dof] = 1.0
            b = body_parentid[b]
    fd = [int(d) for d in dof_frictional]
    fric_onehot = np.zeros((len(fd), nv))
    fric_onehot[np.arange(len(fd)), fd] = 1.0
    lim_j = [j for j in range(njnt) if jnt_limited[j]]
    lim_qadr = [jnt_qposadr[j] for j in lim_j]
    lim_dadr = [jnt_dofadr[j] for j in lim_j]
    lim_onehot = np.zeros((len(lim_j), nv))
    lim_onehot[np.arange(len(lim_j)), lim_dadr] = 1.0
    return mask, fd, fric_onehot, lim_j, lim_qadr, lim_dadr, lim_onehot


def _tables(m: RobotModel):
    return _static_tables(m.nbody, m.nv, m.njnt, m.body_parentid, m.jnt_bodyid, m.jnt_dofadr,
                          m.jnt_type, m.dof_frictional, m.jnt_limited, m.jnt_qposadr)


def contact_point_jacobian(m: RobotModel, com: ComQuantities, point: torch.Tensor,
                           body: torch.Tensor) -> torch.Tensor:
    """Translational Jacobians (B, k, 3, nv) of world points (B, k, 3) on
    bodies (B, k) (per env: they come from the caps' selection)."""
    ref = com.cdof
    mask = torch.as_tensor(_tables(m)[0], dtype=ref.dtype, device=ref.device)[body]  # (B,k,nv)
    root_com = com.subtree_com[:, list(m.body_rootid)]  # (B, nbody, 3)
    offset = point - torch.gather(root_com, 1, body[..., None].expand(-1, -1, 3))
    cd = com.cdof[:, None]  # (B, 1, nv, 6)
    off = offset[:, :, None, :].expand(-1, -1, m.nv, -1)
    jac = cd[..., 3:] + torch.linalg.cross(cd[..., :3].expand_as(off), off)  # (B, k, nv, 3)
    return (jac * mask[..., None]).transpose(-1, -2)


def make_efc(m: RobotModel, com: ComQuantities, qpos: torch.Tensor, qvel: torch.Tensor,
             contacts: Contacts) -> EfcData:
    ref = qvel
    B = ref.shape[0]
    _, fd, fric_onehot, lim_j, lim_qadr, lim_dadr, lim_onehot = _tables(m)

    def t(x):
        return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)

    invw = leaf(m, "dof_invweight0", ref)

    # ---- dof friction-loss rows (always instantiated) ----
    nfl = len(fd)
    J_fric = t(fric_onehot).expand(B, nfl, m.nv)
    pos_fric = ref.new_zeros((B, nfl))
    aref_f, D_f, R_f = _row(leaf(m, "dof_solref", ref)[..., fd, :],
                            leaf(m, "dof_solimp", ref)[..., fd, :], pos_fric, qvel[:, fd],
                            invw[..., fd])
    floss_f = leaf(m, "dof_frictionloss", ref)[..., fd].expand(B, nfl)

    # ---- joint-limit rows: the nearest side, active when violated ----
    nlim = len(lim_j)
    q_l = qpos[:, lim_qadr]
    rng = leaf(m, "jnt_range", ref)[..., lim_j, :]
    dist_lo, dist_hi = q_l - rng[..., 0], rng[..., 1] - q_l
    lower_side = dist_lo < dist_hi
    side = torch.where(lower_side, t(1.0), t(-1.0))
    pos_lim = torch.where(lower_side, dist_lo, dist_hi) - leaf(m, "jnt_margin", ref)[..., lim_j]
    J_lim = t(lim_onehot) * side[..., None]
    aref_l, D_l, R_l = _row(leaf(m, "jnt_solref", ref)[..., lim_j, :],
                            leaf(m, "jnt_solimp", ref)[..., lim_j, :], pos_lim,
                            side * qvel[:, lim_dadr], invw[..., lim_dadr], enable=pos_lim < 0)

    # ---- contact pyramid rows: 4 facets per contact ----
    ncon = contacts.dist.shape[1]
    Jt = (contact_point_jacobian(m, com, contacts.pos, contacts.body2)
          - contact_point_jacobian(m, com, contacts.pos, contacts.body1))  # (B, ncon, 3, nv)
    n, t1, t2 = contacts.frame.unbind(-2)
    mu = contacts.friction
    dirs = torch.stack([n + mu[..., :1] * t1, n - mu[..., :1] * t1,
                        n + mu[..., 1:] * t2, n - mu[..., 1:] * t2], dim=-2)  # (B, ncon, 4, 3)
    J4 = torch.sum(dirs[..., :, :, None] * Jt[..., None, :, :], dim=-2)  # (B, ncon, 4, nv)
    jvel4 = torch.sum(J4 * qvel[:, None, None, :], -1)
    mu2 = mu * mu
    r_t = contacts.invweight[..., None] * 2.0 * mu2 * (1.0 + mu2) / m.impratio
    r4 = r_t.repeat_interleave(2, dim=-1)  # facets [t1+, t1-, t2+, t2-]
    pen4 = contacts.dist[..., None].expand(B, ncon, 4)
    aref_c, D_c, R_c = _row(contacts.solref[..., None, :].expand(B, ncon, 4, 2),
                            contacts.solimp[..., None, :].expand(B, ncon, 4, 5),
                            pen4, jvel4, r4, enable=pen4 < 0)
    ncon4 = ncon * 4

    def flat(x):
        return x.reshape((B, ncon4) + x.shape[3:])

    cat = functools.partial(torch.cat, dim=1)
    is_friction = torch.zeros(nfl + nlim + ncon4, dtype=torch.bool, device=ref.device)
    is_friction[:nfl] = True
    return EfcData(
        J=cat([J_fric, J_lim, flat(J4)]),
        aref=cat([aref_f, aref_l, flat(aref_c)]),
        D=cat([D_f, D_l, flat(D_c)]),
        R=cat([R_f, R_l, flat(R_c)]),
        floss=cat([floss_f, ref.new_zeros((B, nlim + ncon4))]),
        is_friction=is_friction,
        pos=cat([pos_fric, pos_lim, flat(pen4)]),
    )
