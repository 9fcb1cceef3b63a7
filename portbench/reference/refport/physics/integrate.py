"""Semi-implicit Euler (MuJoCo mj_Euler with eulerdamp disabled).

Counterpart of ``puppax/physics/integrate.py``, batched over envs: qvel +=
dt qacc, then position integration, the free joint's quaternion by the
body-frame angular velocity (mju_quatIntegrate).
"""

from __future__ import annotations

import torch

from refport.model.mjcf import JNT_FREE, JNT_HINGE, RobotModel
from refport.ops import math


def integrate_pos(m: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    out = qpos.clone()
    hinge = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_HINGE]
    if hinge:
        qadr = [m.jnt_qposadr[j] for j in hinge]
        dadr = [m.jnt_dofadr[j] for j in hinge]
        out[:, qadr] = qpos[:, qadr] + dt * qvel[:, dadr]
    for j in range(m.njnt):
        if m.jnt_type[j] != JNT_FREE:
            continue
        qa, da = m.jnt_qposadr[j], m.jnt_dofadr[j]
        out[:, qa : qa + 3] = qpos[:, qa : qa + 3] + dt * qvel[:, da : da + 3]
        out[:, qa + 3 : qa + 7] = math.quat_integrate(qpos[:, qa + 3 : qa + 7],
                                                      qvel[:, da + 3 : da + 6], dt)
    return out


def euler(m: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor, qacc: torch.Tensor):
    qvel_new = qvel + m.timestep * qacc
    return integrate_pos(m, qpos, qvel_new, m.timestep), qvel_new
