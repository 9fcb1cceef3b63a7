"""Host-side rendering of rollout trajectories (eval only).

Counterpart of ``puppax/tools/video.py``: qpos rows are rendered with the
MuJoCo C renderer (``render_trajectory``) and written as a video
(``write_video``: mediapy, else the ffmpeg binary, else the raw frames
as ``.npz``). ``mujoco`` is imported inside the functions, so the
package imports on the card's host, which has no mujoco; there
``tools/eval.py::visualize_policy`` records the trajectory to a file, and
a host with mujoco renders it:

    python -m puppax_torch.tools.video <trajectory.npz> [--out PATH]

The file holds the qpos rows, ``render_every``, ``fps``, ``camera`` (""
for MuJoCo's free camera) and the model's MJCF string (``mjcf``); the
video goes to ``--out`` (default: ``step_<N>_policy.mp4`` beside the
file, the name ``visualize_policy`` gives a video it renders itself).
"""

from __future__ import annotations

import argparse
import ctypes.util
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np


def import_mujoco():
    """``import mujoco``, with a headless GL backend chosen first: MuJoCo
    binds its backend at its first import, and on a host without a display
    the default (glfw) fails to render, so MUJOCO_GL=egl when nothing was
    asked for, there is no display and libEGL exists (a backend that is
    not there would make the import itself raise)."""
    if (not os.environ.get("MUJOCO_GL") and not os.environ.get("DISPLAY")
            and ctypes.util.find_library("EGL")):
        os.environ["MUJOCO_GL"] = "egl"
    import mujoco

    return mujoco


def render_trajectory(mj_model, trajectory: List, camera: Optional[str] = "tracking_cam",
                      height: int = 240, width: int = 320) -> Sequence[np.ndarray]:
    """Render ``PhysicsState``s, qpos rows or a ``(T, nq)`` array of a
    ``mujoco.MjModel`` into RGB frames. Raises ``RuntimeError`` where no
    renderer opens (no GL context)."""
    mujoco = import_mujoco()
    try:
        renderer = mujoco.Renderer(mj_model, height=height, width=width)
    except Exception as exc:  # no GL context available (headless host)
        raise RuntimeError(f"renderer unavailable: {exc}") from exc
    data = mujoco.MjData(mj_model)
    frames = []
    for s in trajectory:
        qpos = s.qpos if hasattr(s, "qpos") else s
        data.qpos[:] = np.asarray(qpos.detach().cpu() if hasattr(qpos, "detach") else qpos)
        mujoco.mj_forward(mj_model, data)
        renderer.update_scene(data, camera=camera)
        frames.append(renderer.render())
    renderer.close()
    return frames


def write_video(path: str, frames: Sequence[np.ndarray], fps: float) -> str:
    """Write frames to mp4 (mediapy, else ffmpeg, else a ``.npz`` beside
    ``path``); returns the path written."""
    try:
        import mediapy as media

        media.write_video(path, frames, fps=fps)
        return path
    except ImportError:
        pass
    if shutil.which("ffmpeg"):
        with tempfile.TemporaryDirectory() as tmp:
            for i, f in enumerate(frames):
                _write_ppm(os.path.join(tmp, f"{i:06d}.ppm"), f)
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
                 "-i", os.path.join(tmp, "%06d.ppm"), "-pix_fmt", "yuv420p", path],
                check=True,
            )
        return path
    alt = os.path.splitext(path)[0] + ".npz"
    np.savez_compressed(alt, frames=np.stack(frames), fps=fps)
    return alt


def _write_ppm(path: str, frame: np.ndarray) -> None:
    h, w = frame.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode())
        f.write(np.ascontiguousarray(frame[..., :3], dtype=np.uint8).tobytes())


def render_file(trajectory_path: str, out: Optional[str] = None) -> str:
    """Render a trajectory file of ``visualize_policy``: its MJCF compiled,
    every ``render_every``-th qpos row rendered from its camera, the video
    written at its fps. Returns the path ``write_video`` wrote."""
    mujoco = import_mujoco()
    with np.load(trajectory_path) as f:
        rec = {k: f[k] for k in f.files}
    model = mujoco.MjModel.from_xml_string(str(rec["mjcf"]))
    frames = render_trajectory(model, rec["qpos"][:: int(rec["render_every"])],
                               camera=str(rec["camera"]) or None)
    if out is None:  # visualize_policy's video name; never the file itself as .npz
        base = os.path.splitext(trajectory_path)[0]
        base = base[: -len("_trajectory")] if base.endswith("_trajectory") else base + "_video"
        out = base + ".mp4"
    return write_video(out, frames, fps=int(rec["fps"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Render a recorded policy trajectory to a video.")
    ap.add_argument("trajectory", help="a step_<N>_policy_trajectory.npz of visualize_policy")
    ap.add_argument("--out", default=None, help="video path (default: step_<N>_policy.mp4 beside the file)")
    args = ap.parse_args(argv)
    print(render_file(args.trajectory, args.out))


if __name__ == "__main__":
    main()
