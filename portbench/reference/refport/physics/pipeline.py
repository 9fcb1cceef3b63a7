"""The physics pipeline: forward dynamics, init and step.

Counterpart of ``puppax/physics/pipeline.py``. ``forward`` chains the
stages of ``smooth``, ``collision``, ``constraint`` and ``solver`` (the
MJX contact caps included); ``pipeline_step`` runs ``n_substeps`` forward
+ Euler passes as a Python loop and keeps the caches of the last forward
pass (mjx.step semantics: the caches lag integration by one substep).
Everything is batched over a leading env axis ``(B, ...)`` and runs in the
state's dtype, float64 included.

``make_batched_step`` is the env's physics step: ``pipeline_step`` on
every route (the JAX package's custom_vmap splice sends the kernel's class
of model to the physics-step kernel instead; the reference has no kernel).
The kernels' emission evaluates every contact pair uncapped, so the two
part once more than ``max_geom_pairs`` pairs of one kind (or
``max_contact_points`` in all) penetrate, unless the caps are raised to
the number of pairs (``uncapped``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from refport import utils
from refport.model.mjcf import LEAF_FIELDS, MjTables, RobotModel
from refport.ops import linalg
from refport.physics import collision, constraint, integrate, smooth, soa, solver


@dataclass(frozen=True)
class PhysicsState:
    """The physics caches of the last forward pass, batched: qpos (B, nq),
    qvel (B, nv), qacc (B, nv), x_pos (B, nbody-1, 3), x_rot (B, nbody-1,
    4), xd_vel and xd_ang (B, nbody-1, 3), xpos (B, nbody, 3), site_xpos
    (B, nsite, 3), qfrc_actuator (B, nv), and the uncapped contact report
    in static pair order: contact_dist (B, npair), contact_pos (B, npair,
    3). The world body is dropped from the ``x_*``/``xd_*`` fields, as in
    brax. The per-pair geoms and bodies are static; the env keeps what its
    rewards read (``pair_contact_statics``)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    qacc: torch.Tensor
    x_pos: torch.Tensor
    x_rot: torch.Tensor
    xd_vel: torch.Tensor
    xd_ang: torch.Tensor
    xpos: torch.Tensor
    site_xpos: torch.Tensor
    qfrc_actuator: torch.Tensor
    contact_dist: torch.Tensor
    contact_pos: torch.Tensor

    @property
    def q(self) -> torch.Tensor:
        return self.qpos

    @property
    def qd(self) -> torch.Tensor:
        return self.qvel

    def replace(self, **updates) -> "PhysicsState":
        return dataclasses.replace(self, **updates)

    def map(self, fn, *others: "PhysicsState") -> "PhysicsState":
        """A PhysicsState of ``fn(field, *others' fields)`` for every field."""
        return PhysicsState(**{
            f.name: fn(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)
        })


def model_tensors(m: RobotModel, dtype: torch.dtype, device) -> RobotModel:
    """``m`` with every numeric leaf a tensor of ``dtype`` on ``device``, so
    the stages convert nothing per call."""
    return m.replace(**{k: torch.as_tensor(getattr(m, k), dtype=dtype, device=device)
                        for k in LEAF_FIELDS})


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 products in full float32 (TF32 off): the counterpart of the
    JAX pass's ``default_matmul_precision("highest")``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def forward(m: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor):
    """One forward-dynamics pass of (B, ...) states; returns (qacc, caches)
    with caches (kin, com, vel, contacts, qfrc_actuator)."""
    with _full_fp32_matmul():
        kin = smooth.kinematics(m, qpos)
        com = smooth.com_pos(m, kin)
        vel = smooth.com_vel(m, com, qvel)
        qM = smooth.crb(m, com)
        qfrc_bias = smooth.rne(m, com, vel, qvel)
        qfrc_actuator = smooth.actuation(m, qpos, qvel, ctrl)
        qfrc_smooth = smooth.passive(m, qvel) + qfrc_actuator - qfrc_bias
        qacc_smooth = linalg.spd_solve(qM, qfrc_smooth)
        contacts = collision.collide(m, kin)
        efc = constraint.make_efc(m, com, qpos, qvel, contacts)
        res = solver.solve(m, qM, qacc_smooth, efc)
        return res.qacc, (kin, com, vel, contacts, qfrc_actuator)


def _make_state(m: RobotModel, qpos, qvel, qacc, caches) -> PhysicsState:
    kin, com, vel, _, qfrc_actuator = caches
    # world-frame link velocities from the com-referenced spatial ones:
    # v_origin = cvel_lin + cvel_ang x (xpos - subtree_com[root])
    offset = kin.xpos - com.subtree_com[:, list(m.body_rootid)]
    ang = vel.cvel[..., :3]
    lin = vel.cvel[..., 3:] + torch.linalg.cross(ang, offset)
    # the report is the uncapped per-pair set (MuJoCo C semantics); the
    # solver used the capped set (MJX dynamics semantics)
    report = collision.collide_pairs(m, kin)
    return PhysicsState(
        qpos=qpos, qvel=qvel, qacc=qacc, x_pos=kin.xpos[:, 1:], x_rot=kin.xquat[:, 1:],
        xd_vel=lin[:, 1:], xd_ang=ang[:, 1:], xpos=kin.xpos, site_xpos=kin.site_xpos,
        qfrc_actuator=qfrc_actuator, contact_dist=report.dist, contact_pos=report.pos,
    )


def pipeline_init(m: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor) -> PhysicsState:
    """The state of (B, nq) qpos and (B, nv) qvel after one forward pass at
    zero controls (mjx.forward semantics)."""
    m = model_tensors(m, qpos.dtype, qpos.device)
    ctrl = qpos.new_zeros((qpos.shape[0], m.nu))
    qacc, caches = forward(m, qpos, qvel, ctrl)
    return _make_state(m, qpos, qvel, qacc, caches)


def pipeline_step(m: RobotModel, state: PhysicsState, ctrl: torch.Tensor,
                  n_substeps: int = 5) -> PhysicsState:
    """Advance ``n_substeps`` physics steps under constant (B, nu) ctrl (one
    env step); the caches are those of the last substep's forward pass."""
    m = model_tensors(m, state.qpos.dtype, state.qpos.device)
    qpos, qvel = state.qpos, state.qvel
    for _ in range(n_substeps):
        qacc, caches = forward(m, qpos, qvel, ctrl)
        qpos, qvel = integrate.euler(m, qpos, qvel, qacc)
    return _make_state(m, qpos, qvel, qacc, caches)


def npair(m: RobotModel) -> int:
    """The contact rows of every candidate pair (a plane-capsule pair has
    two)."""
    return (len(m.pairs_plane_sphere) + len(m.pairs_sphere_sphere) + len(m.pairs_sphere_box)
            + len(m.pairs_hfield_sphere) + 2 * len(m.pairs_plane_capsule)
            + len(m.pairs_sphere_capsule) + len(m.pairs_capsule_capsule))


def zeros_state(m: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor) -> PhysicsState:
    """A PhysicsState carrying qpos and qvel (all ``pipeline_step`` reads)."""
    B = qpos.shape[0]
    z = qpos.new_zeros
    k = npair(m)
    return PhysicsState(
        qpos=qpos, qvel=qvel, qacc=z((B, m.nv)), x_pos=z((B, m.nbody - 1, 3)),
        x_rot=z((B, m.nbody - 1, 4)), xd_vel=z((B, m.nbody - 1, 3)),
        xd_ang=z((B, m.nbody - 1, 3)), xpos=z((B, m.nbody, 3)), site_xpos=z((B, m.nsite, 3)),
        qfrc_actuator=z((B, m.nv)), contact_dist=z((B, k)), contact_pos=z((B, k, 3)),
    )


def _as_tuple(ps: PhysicsState) -> tuple:
    return tuple(getattr(ps, f.name) for f in dataclasses.fields(ps))


def make_batched_step(base_model: RobotModel, n_substeps: int, mj: MjTables = None):
    """``step(model, qpos, qvel, ctrl, dr_rows=None) -> tuple`` of one env
    step's physics through ``pipeline_step`` in the state's dtype. The
    tuple is PhysicsState's fields in order (qpos, qvel, qacc, x_pos,
    x_rot, xd_vel, xd_ang, xpos, site_xpos, qfrc_actuator, contact_dist,
    contact_pos); ``dr_rows`` (the kernels' parameter rows) is not read."""

    def step(model, qpos, qvel, ctrl, dr_rows=None):
        ps = pipeline_step(model, zeros_state(model, qpos, qvel), ctrl, n_substeps)
        return _as_tuple(ps)

    return step


def uncapped(m: RobotModel) -> RobotModel:
    """``m`` with the contact caps raised to its number of contact rows, so
    that every penetrating pair reaches the solver, as in the kernels."""
    n = npair(m)
    return m.replace(max_geom_pairs=n, max_contact_points=n)


def pair_contact_statics(base_model: RobotModel, mj: MjTables = None, device=None):
    """Static per-pair contact metadata of the emitter's model class (pair order
    of the contact report): frames, solref, solimp, invweight as float32
    tensors, geom and body ids as int64 tensors, and ``pair_geoms``; on
    ``device`` (default ``cuda:0``; ``"cpu"`` must be asked for)."""
    s = soa._Static(base_model, mj)
    device = utils.resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def ids(name):
        return torch.as_tensor([getattr(p, name) for p in s.pairs], dtype=torch.int64,
                               device=device)

    return dict(
        frame=f32([[p.plane_n, p.frame_t1, p.frame_t2] for p in s.pairs]),
        solref=f32([p.solref for p in s.pairs]),
        solimp=f32([p.solimp for p in s.pairs]),
        invweight=f32([p.invweight for p in s.pairs]),
        geom1=ids("geom1"), geom2=ids("geom2"), body1=ids("body1"), body2=ids("body2"),
        pair_geoms=[(p.geom1, p.geom2) for p in s.pairs],
    )
