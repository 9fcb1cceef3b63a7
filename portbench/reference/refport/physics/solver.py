"""Primal Newton constraint solver (MuJoCo semantics), batched over envs.

Counterpart of ``puppax/physics/solver.py``. Minimizes over qacc

    0.5 (x - x_smooth)' M (x - x_smooth) + sum_i s_i(J_i x - aref_i)

with s_i the convex row cost: 0.5 D jar^2 on one-sided rows (limits,
pyramid facets) where jar < 0; on friction-loss rows the Huber cost that
saturates the force at +-floss. Each Newton iteration builds the exact
Hessian over the active set, takes a Cholesky step (``ops/linalg``), and
runs an exact line search: phi'(alpha) is piecewise linear, so it is
evaluated at every activity breakpoint (a ``(B, 3 nefc + 1, nefc)``
tensor, no loop over envs) and its root solved on the bracketing segment.
With ``solver_iterations > 1`` an env stops stepping once its scaled
gradient or improvement drops under ``tolerance`` (mj_solNewton).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refport.model.mjcf import RobotModel
from refport.ops import linalg
from refport.physics.constraint import EfcData


class SolverResult(NamedTuple):
    qacc: torch.Tensor  # (B, nv)
    efc_force: torch.Tensor  # (B, nefc)
    qfrc_constraint: torch.Tensor  # (B, nv)


def _weighted_gram(J: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """J.T diag(w) J for (B, nefc, nv) J."""
    return torch.sum(w[..., :, None, None] * J[..., :, :, None] * J[..., :, None, :], dim=-3)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, -1)


def _row_cost(efc: EfcData, jar: torch.Tensor) -> torch.Tensor:
    """Total convex row cost at jar, per env."""
    quad = 0.5 * efc.D * jar * jar
    lin = efc.floss * torch.abs(jar) - 0.5 * efc.floss * efc.floss * efc.R
    cost_fric = torch.where(torch.abs(jar) <= efc.floss * efc.R, quad, lin)
    cost_onesided = torch.where(jar < 0, quad, torch.zeros_like(quad))
    return torch.sum(torch.where(efc.is_friction, cost_fric, cost_onesided), -1)


def _row_force(efc: EfcData, jar: torch.Tensor):
    """Per-row constraint force and quadratic-zone mask at jar."""
    quad = torch.where(efc.is_friction, torch.abs(jar) <= efc.floss * efc.R, jar < 0)
    lin_force = torch.where(efc.is_friction, -torch.sign(jar) * efc.floss,
                            torch.zeros_like(jar))
    return torch.where(quad, -efc.D * jar, lin_force), quad


def solve(m: RobotModel, qM: torch.Tensor, qacc_smooth: torch.Tensor,
          efc: EfcData) -> SolverResult:
    x = qacc_smooth
    # costs and gradients are normalized by meaninertia * max(1, nv) before
    # the comparison with opt.tolerance (mj_solNewton)
    scale = 1.0 / max(m.meaninertia * max(1, m.nv), 1e-30)
    tol = m.tolerance
    active = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    n_iter = max(m.solver_iterations, 1)
    big = 1e12

    for it in range(n_iter):
        jar = linalg.mv(efc.J, x) - efc.aref
        force, quad = _row_force(efc, jar)
        ma = linalg.mv(qM, x - qacc_smooth)
        grad = ma - linalg.mtv(efc.J, force)
        # pre-step gradient exit (mj: gradient < tolerance)
        active = active & (scale * torch.sqrt(_dot(grad, grad)) >= tol)
        H = qM + _weighted_gram(efc.J, efc.D * quad.to(x.dtype))
        dx = -linalg.spd_solve(H, grad)

        # exact line search on the piecewise-linear phi'
        jv = linalg.mv(efc.J, dx)
        g0 = _dot(dx, ma)
        h0 = torch.clamp_min(_dot(dx, linalg.mv(qM, dx)), 1e-12)

        def dphi(alpha):  # alpha (B, k) -> phi'(alpha) (B, k)
            dja = efc.D[:, None] * (jar[:, None] + alpha[..., None] * jv[:, None])
            fl = efc.floss[:, None]
            s = torch.where(efc.is_friction, torch.minimum(torch.maximum(dja, -fl), fl),
                            torch.clamp_max(dja, 0.0))
            return g0[:, None] + alpha * h0[:, None] + torch.sum(s * jv[:, None], -1)

        nonzero = torch.abs(jv) > 1e-12
        safe_jv = torch.where(nonzero, jv, torch.ones_like(jv))
        valid = nonzero & (efc.D > 0)
        bigt = torch.full_like(jv, big)
        bp0 = torch.where(valid, -jar / safe_jv, bigt)
        fl_over_d = efc.floss / torch.clamp_min(efc.D, 1e-30)
        vf = valid & efc.is_friction
        bp_lo = torch.where(vf, (-fl_over_d - jar) / safe_jv, bigt)
        bp_hi = torch.where(vf, (fl_over_d - jar) / safe_jv, bigt)
        bps = torch.cat([bp0, bp_lo, bp_hi, jv.new_zeros((jv.shape[0], 1))], -1)
        neg = dphi(bps) <= 0
        # bracket: the largest breakpoint with phi' <= 0, the smallest with phi' > 0
        a_lo = torch.amax(torch.where(neg, bps, torch.full_like(bps, -big)), -1)
        a_hi = torch.amin(torch.where(neg, torch.full_like(bps, big), bps), -1)
        mid = torch.where(a_hi < big, 0.5 * (a_lo + a_hi), a_lo + 1.0)
        f_lo = dphi(a_lo[:, None])[:, 0]
        f_mid = dphi(mid[:, None])[:, 0]
        slope = torch.clamp_min((f_mid - f_lo) / torch.clamp_min(mid - a_lo, 1e-30), 1e-12)
        alpha = torch.clamp_min(a_lo - f_lo / slope, 0.0)  # descent safeguard

        x_old = x
        x = torch.where(active[:, None], x + alpha[:, None] * dx, x)
        if it < n_iter - 1:
            # post-step improvement exit (mj: improvement < tolerance)
            cost_old = 0.5 * _dot(x_old - qacc_smooth, ma) + _row_cost(efc, jar)
            jar_new = linalg.mv(efc.J, x) - efc.aref
            ma_new = linalg.mv(qM, x - qacc_smooth)
            cost_new = 0.5 * _dot(x - qacc_smooth, ma_new) + _row_cost(efc, jar_new)
            active = active & (scale * (cost_old - cost_new) >= tol)

    force, _ = _row_force(efc, linalg.mv(efc.J, x) - efc.aref)
    return SolverResult(qacc=x, efc_force=force, qfrc_constraint=linalg.mtv(efc.J, force))
