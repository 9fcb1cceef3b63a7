"""Train a Pupper v3 joystick policy with the port from an ExperimentConfig.

Counterpart of ``scripts/train.py``: builds the env, the DR fn, the JSONL
metrics sink and checkpointing from one config and runs
``puppax_torch.train.ppo.train`` on one device, or as one rank of a
multi-GPU run.

Usage:
  python -m puppax_torch.scripts.train [--config cfg.json]
      [--set train.num_envs=8192 ...] [--resume] [--wandb] [--device cuda|cpu]
  python -m torch.distributed.run --nproc_per_node N -m puppax_torch.scripts.train ...

Under the launcher (one process per GPU: ``torch.distributed.run`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the group's address) each
process joins the process group before it touches its device
(``parallel.maybe_initialize_distributed``: NCCL on the card, gloo with
``--device cpu``), trains on ``cuda:LOCAL_RANK`` with its share of the
envs, and only rank 0 writes the metrics JSONL and the checkpoints (and,
with ``--wandb`` and a live ``wandb`` run, logs to W&B and uploads each
checkpoint directory as a model artifact).

It prints ``config hash: ...``, then the final metrics as JSON. With
``train.checkpoint_path`` set it saves the policy parameters at every eval
epoch under ``<checkpoint_path>/<step>/`` and the full train state under
``<checkpoint_path>/state/<step>/``; ``--resume`` restarts from the latest
train state. With ``train.progress_plot`` set, the eval-reward curve is
rendered again to that PNG at every eval epoch.
"""

from __future__ import annotations

import argparse
import functools
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a Pupper v3 policy with puppax_torch.")
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted-path override, e.g. train.num_envs=8192",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the latest train-state checkpoint in train.checkpoint_path",
    )
    parser.add_argument("--wandb", action="store_true",
                        help="log to W&B too (rank 0, where a wandb run is live)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda, cuda:LOCAL_RANK under the launcher)")
    args = parser.parse_args(argv)

    from puppax_torch.configs import experiment as exp

    cfg = exp.ExperimentConfig()
    if args.config:
        with open(args.config) as f:
            cfg = exp.from_dict(json.load(f))
    if args.set:
        cfg = exp.apply_overrides(cfg, dict(exp.parse_override(s) for s in args.set))

    import torch.distributed as dist

    from puppax_torch.parallel import mesh as mesh_lib

    # join the process group (a launcher's rank) before touching the device
    device = mesh_lib.rank_device() if args.device == "cuda" else args.device
    started = not dist.is_initialized() and mesh_lib.maybe_initialize_distributed(device=device)
    try:
        return _train(args, cfg, mesh_lib.make_env_mesh([device]))
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, mesh):
    """The run on this process's device (``mesh``: a rank's, or one process's)."""
    from puppax_torch.configs import experiment as exp
    from puppax_torch.configs import get_config
    from puppax_torch.env.domain_randomization import domain_randomize
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.tools.metrics import MetricsLogger, make_progress_fn
    from puppax_torch.train import checkpoint, ppo
    from puppax_torch.train.networks import make_ppo_networks

    # multi-GPU: only rank 0 writes metrics and checkpoints (shared storage)
    is_lead = mesh.is_lead
    print(f"config hash: {exp.config_hash(cfg)}", flush=True)
    device = mesh.device
    env = PupperV3Env.from_config(cfg.env, reward_config=get_config(), device=device)

    dr = cfg.domain_randomization
    randomization_fn = None
    if dr.enabled:
        ranges = {k: v for k, v in exp.to_dict(dr).items() if k != "enabled"}
        randomization_fn = functools.partial(domain_randomize, **ranges)

    t = cfg.train
    logger = MetricsLogger(jsonl_path=t.metrics_jsonl if is_lead else None,
                           use_wandb=args.wandb and is_lead)
    logger.log({"config_hash": exp.config_hash(cfg)}, step=0)
    progress = make_progress_fn(logger, plot_path=t.progress_plot)

    def policy_params_fn(step, make_policy, params):
        if t.checkpoint_path and is_lead:
            path = checkpoint.save_checkpoint(step, ppo.params_state_dict(params),
                                              t.checkpoint_path)
            logger.log_artifact(path, name=f"checkpoint_{step}")

    network_factory = functools.partial(
        make_ppo_networks,
        policy_hidden_layer_sizes=t.policy_hidden_layer_sizes,
        value_hidden_layer_sizes=t.value_hidden_layer_sizes,
        activation=t.activation,
        value_precision=t.value_precision,
    )

    make_policy, params, metrics = ppo.train(
        env,
        num_timesteps=t.num_timesteps,
        episode_length=t.episode_length,
        num_envs=t.num_envs,
        num_eval_envs=t.num_eval_envs,
        learning_rate=t.learning_rate,
        lr_schedule=t.lr_schedule,
        lr_final_fraction=t.lr_final_fraction,
        entropy_cost=t.entropy_cost,
        entropy_schedule=t.entropy_schedule,
        entropy_cost_final=t.entropy_cost_final,
        discounting=t.discounting,
        unroll_length=t.unroll_length,
        batch_size=t.batch_size,
        num_minibatches=t.num_minibatches,
        num_updates_per_batch=t.num_updates_per_batch,
        reward_scaling=t.reward_scaling,
        clipping_epsilon=t.clipping_epsilon,
        gae_lambda=t.gae_lambda,
        normalize_observations=t.normalize_observations,
        lazy_shuffle=t.lazy_shuffle,
        seed=t.seed,
        num_evals=t.num_evals,
        network_factory=network_factory,
        privileged_critic=t.privileged_critic,
        curriculum_steps=t.curriculum_steps,
        randomization_fn=randomization_fn,
        progress_fn=progress,
        policy_params_fn=policy_params_fn,
        device=device,
        checkpoint_dir=t.checkpoint_path,
        resume=args.resume,
        metrics_logger=logger,
    )
    print(json.dumps(metrics, default=float, indent=2))
    if t.checkpoint_path and is_lead:
        path = checkpoint.save_checkpoint(t.num_timesteps, ppo.params_state_dict(params),
                                          t.checkpoint_path)
        logger.log_artifact(path, name=f"checkpoint_{t.num_timesteps}")
        print(f"final checkpoint: {path}")
    return metrics


if __name__ == "__main__":
    main()
