"""Export a checkpoint of the port to the on-robot JSON policy.

Counterpart of ``scripts/export_policy.py``: reads a checkpoint
``<checkpoint>/<step>/checkpoint.pt`` (``train/checkpoint.py``; the
params tree ``ppo.params_state_dict`` writes, as the training CLI saves at
every evaluation, or a train-state tree, whose ``["params"]`` it takes),
folds the normalizer into the first layer, and writes the JSON dict the
robot's runtime consumes.

Usage:
  python -m puppax_torch.scripts.export_policy --checkpoint /path/ckpt [--step N] \
      --out policy.json [--activation elu] [--action-scale 0.75] ... [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from dataclasses import replace


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export a puppax_torch checkpoint to JSON.")
    parser.add_argument("--checkpoint", required=True, help="checkpoint dir")
    parser.add_argument("--step", type=int, default=None, help="step (default latest)")
    parser.add_argument("--out", required=True, help="output JSON path")
    parser.add_argument("--activation", default="elu")
    parser.add_argument("--action-scale", type=float, default=0.75)
    parser.add_argument("--kp", type=float, default=5.0)
    parser.add_argument("--kd", type=float, default=0.25)
    parser.add_argument("--observation-history", type=int, default=2)
    parser.add_argument("--maximum-pitch-command", type=float, default=0.0)
    parser.add_argument("--maximum-roll-command", type=float, default=0.0)
    parser.add_argument("--no-imu", action="store_true")
    parser.add_argument(
        "--gait-phase-observation", action="store_true",
        help="policy was trained with the (cos, sin) gait clock appended "
        "to the obs; the exported JSON tells the on-robot runtime to "
        "append and advance the clock",
    )
    parser.add_argument("--gait-frequency", type=float, default=2.5)
    parser.add_argument("--control-dt", type=float, default=0.02)
    parser.add_argument("--device", default=None,
                        help="torch device of the env (default: the first CUDA device)")
    args = parser.parse_args(argv)

    from puppax_torch import utils
    from puppax_torch.configs import EnvConfig, get_config
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.export import convert_params
    from puppax_torch.export.params import normalizer_arrays
    from puppax_torch.train import checkpoint

    device = utils.resolve_device(args.device)
    tree = checkpoint.restore_checkpoint(args.checkpoint, step=args.step)
    if "policy" not in tree and "params" in tree:  # a train-state checkpoint
        tree = tree["params"]
    normalizer, policy = tree["normalizer"], tree["policy"]

    env = PupperV3Env.from_config(
        replace(EnvConfig(), action_scale=args.action_scale,
                observation_history=args.observation_history),
        reward_config=get_config(), device=device,
    )
    # the gait flag must match how the policy was trained: the clock adds
    # 2 obs dims, so the checkpoint's normalizer width is the ground truth
    # (exporting with the wrong flag would silently misalign the runtime's
    # clock features against real observation dims)
    expected = env.observation_size + (2 if args.gait_phase_observation else 0)
    got = int(normalizer_arrays(normalizer)[0].size)
    if got != expected:
        hint = (
            "trained WITH the gait clock: pass --gait-phase-observation"
            if got == env.observation_size + 2
            else "trained WITHOUT the gait clock: drop --gait-phase-observation"
            if got == env.observation_size
            else "check --observation-history"
        )
        raise SystemExit(f"checkpoint obs width {got} != expected {expected} ({hint})")
    exported = convert_params(
        (normalizer, policy),
        activation=args.activation,
        action_scale=args.action_scale,
        kp=args.kp,
        kd=args.kd,
        default_pose=env._default_pose,
        joint_upper_limits=env.uppers,
        joint_lower_limits=env.lowers,
        use_imu=not args.no_imu,
        observation_history=args.observation_history,
        maximum_pitch_command=args.maximum_pitch_command,
        maximum_roll_command=args.maximum_roll_command,
        gait_phase_observation=args.gait_phase_observation,
        gait_frequency=args.gait_frequency,
        control_dt=args.control_dt,
    )
    with open(args.out, "w") as f:
        json.dump(exported, f)
    n_params = sum(
        len(layer["weights"][1]) * (len(layer["weights"][0]) + 1)
        for layer in exported["layers"]
    )
    print(f"wrote {args.out}: {len(exported['layers'])} layers, ~{n_params} params, "
          f"in_shape={exported['in_shape']}")
    return exported


if __name__ == "__main__":
    main()
