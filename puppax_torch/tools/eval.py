"""Policy visualization: a scripted-command rollout, recorded and rendered.

Counterpart of ``puppax/tools/eval.py::visualize_policy``: a 560-step
rollout of one env cycling through 7 joystick commands, ``n_steps // 7``
steps each, on the env's device (on the card each step is one team K2
launch through ``env.step``, K1 under ``PUPPAX_SOA_ENV=off``). The qpos
rows are always written to ``step_<N>_policy_trajectory.npz`` with what
rendering needs (the model's MJCF string among it), since the card's host
has no mujoco; where mujoco imports and a renderer opens, the rollout is
rendered to ``step_<N>_policy.mp4`` at half the control rate and logged
as the JAX package logs it. Elsewhere ``python -m
puppax_torch.tools.video <file>`` renders the file on a host with mujoco.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from puppax_torch import random
from puppax_torch.tools import video
from puppax_torch.tools.metrics import MetricsLogger


def command_script(vx: float, vy: float, wz: float) -> np.ndarray:
    """The 7 commands (vx, vy, wz) of the rollout, in order: stand, then
    forward, back, left, right, turn left, turn right."""
    return np.array([
        [0.0, 0.0, 0.0],
        [vx, 0.0, 0.0],
        [-vx, 0.0, 0.0],
        [0.0, vy, 0.0],
        [0.0, -vy, 0.0],
        [0.0, 0.0, wz],
        [0.0, 0.0, -wz],
    ], np.float32)


def visualize_policy(
    current_step: int,
    make_policy: Callable,
    params,
    eval_env,
    step_fn: Callable,
    reset_fn: Callable,
    output_folder: str,
    vx: float = 0.5,
    vy: float = 0.4,
    wz: float = 1.5,
    n_steps: int = 560,
    render_every: int = 2,
    camera: str = "tracking_cam",
    logger: Optional[MetricsLogger] = None,
    mjcf: Optional[str] = None,
) -> Optional[str]:
    """Roll out the policy under the scripted commands, record, render.

    ``params`` is the callback pair ``(normalizer, PPONetworkParams)``; the
    policy is ``make_policy((params[0], params[1].policy))``. ``reset_fn``
    and ``step_fn`` are the (unwrapped) env's ``reset`` and ``step`` on a
    batch of one env: the key is ``PRNGKey(0)``, split before each step
    into the action's key and the next. ``mjcf`` is the env's MJCF string
    (default: the bundled model's, ``tables.config_xml(EnvConfig())``; pass
    ``config_xml`` of another config). Returns the video path, or None
    where mujoco or a renderer is missing."""
    policy = make_policy((params[0], params[1].policy))
    device = eval_env.device
    script = command_script(vx, vy, wz)
    per_command = max(1, n_steps // len(script))
    index = [min(i // per_command, len(script) - 1) for i in range(n_steps)]
    commands = torch.as_tensor(script, device=device)

    key = random.key(0, device)
    qpos = []
    with torch.no_grad():
        state = reset_fn(key[None])
        qpos.append(state.qpos)
        for i in range(n_steps):
            act_key, key = random.split(key).unbind(0)
            state = state.replace(info=dict(state.info, command=commands[index[i]][None]))
            ctrl, _ = policy(state.obs, act_key)
            state = step_fn(state, ctrl)
            qpos.append(state.qpos)
    qpos = torch.cat(qpos).cpu().numpy()

    if mjcf is None:
        from puppax_torch.configs import EnvConfig
        from puppax_torch.model.tables import config_xml

        mjcf = config_xml(EnvConfig())
    fps = int(1.0 / eval_env.dt / render_every)
    os.makedirs(output_folder, exist_ok=True)
    np.savez_compressed(
        os.path.join(output_folder, f"step_{current_step}_policy_trajectory.npz"),
        qpos=qpos, commands=script[index], dt=eval_env.dt, render_every=render_every,
        fps=fps, camera=camera or "", mjcf=mjcf)

    try:
        mujoco = video.import_mujoco()
    except ImportError:
        return None
    try:
        frames = video.render_trajectory(mujoco.MjModel.from_xml_string(mjcf),
                                         qpos[::render_every], camera=camera)
    except RuntimeError:
        return None
    path = video.write_video(os.path.join(output_folder, f"step_{current_step}_policy.mp4"),
                             frames, fps=fps)
    if logger is not None:
        logger.log(
            {
                "eval/video/command/vx": vx,
                "eval/video/command/vy": vy,
                "eval/video/command/wz": wz,
                "eval/video_path": path,
            },
            step=current_step,
        )
    return path
