#!/usr/bin/env python3
"""Convert a JAX package's orbax checkpoint into the port's layout.

    python convert_orbax_checkpoint.py --checkpoint ckpts/run12 --out ckpts/run12_torch [--step N]
    python convert_orbax_checkpoint.py --checkpoint ckpts/run12/state --out ckpts/run12_torch [--step N]

Run it where JAX and orbax live (the PyTorch port imports neither). It reads
``<checkpoint>/<step>/`` (default: the latest step) with
``puppax.train.checkpoint.restore_checkpoint`` on the CPU and turns its
leaves into numpy arrays. Two kinds convert:

* the params tree ``(normalizer, PPONetworkParams)`` that
  ``scripts/train.py`` saves at every evaluation and at the end, written to
  ``<out>/<step>/checkpoint.pt`` through
  ``puppax_torch.train.checkpoint.save_jax_params``. The result goes
  through the port's export CLI (``python -m
  puppax_torch.scripts.export_policy --checkpoint <out> ...``) and its
  native replay;
* a train state (``<ckpt>/state/<step>/``, ``puppax/train/ppo.py``'s
  ``TrainingState``: optax's adam state, alone or after
  ``clip_by_global_norm``, the params, the normalizers and the two-limb
  env-step count), written to ``<out>/state/<step>/checkpoint.pt``
  through ``save_jax_train_state``; ``ppo.train(checkpoint_dir=<out>,
  resume=True)`` (the CLI's ``--resume`` with ``train.checkpoint_path=<out>``)
  resumes from it. Another optimizer's state is refused.

A privileged critic's wider value net and its normalizer convert the same
way.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True,
                        help="the JAX package's checkpoint directory (<checkpoint>/<step>/)")
    parser.add_argument("--out", required=True, help="the port's checkpoint directory")
    parser.add_argument("--step", type=int, default=None, help="step (default: the latest)")
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from puppax.train import checkpoint as jax_checkpoint
    from puppax_torch.train import checkpoint

    step = args.step
    if step is None:
        step = jax_checkpoint.latest_checkpoint_step(args.checkpoint)
        if step is None:
            raise SystemExit(f"no checkpoints under {args.checkpoint}")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_checkpoint.restore_checkpoint(args.checkpoint, step=step))
    if isinstance(tree, dict) and "optimizer_state" in tree:
        try:
            path = checkpoint.save_jax_train_state(step, tree, os.path.join(args.out, "state"))
        except ValueError as e:
            raise SystemExit(f"{args.checkpoint}/{step}: {e}")
        print(f"wrote {path}: the train state at step {step} (env steps "
              f"{checkpoint.restore_checkpoint(os.path.join(args.out, 'state'), step)['env_steps']}"
              f"); resume it with ppo.train(checkpoint_dir={args.out!r}, resume=True)")
        return path
    if not (isinstance(tree, (list, tuple)) and len(tree) == 2):
        raise SystemExit(f"{args.checkpoint}/{step}: expected the params tree "
                         f"(normalizer, PPONetworkParams), got {type(tree).__name__}")
    path = checkpoint.save_jax_params(step, tree, args.out)
    value_in = int(np.asarray(tree[1]["value"]["params"]["hidden_0"]["kernel"]).shape[0])
    obs = int(np.asarray(tree[0]["mean"]).size)
    print(f"wrote {path}: step {step}, observation width {obs}, value input width {value_in}"
          + (f" ({value_in - obs} privileged)" if value_in != obs else ""))
    return path


if __name__ == "__main__":
    main()
