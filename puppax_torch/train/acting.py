"""The transition record, the standard-lane unroll and the evaluator.

Counterpart of ``puppax/train/acting.py``. ``generate_unroll`` steps a
wrapped env (``env/wrappers.py::TrainingEnv``: the env-step kernel K2 on
the card, or the physics-only lane on K1) under a policy, one Python
iteration per step; the JAX ``scan`` has no counterpart. It serves the
evaluator and, when the fast lane is off, training: its transitions stack
as ``FastLane.unroll``'s do (time-major, ``log_prob`` (T, B) and
``raw_action`` (T, B, act) in ``policy_extras``). ``Evaluator`` runs full eval episodes and aggregates
the ``eval/episode_*`` metrics with the JAX package's episode masking and
metric names. Every draw comes from jax keys (``puppax_torch.random``) on
the JAX package's key chains: per step ``current, next = split(key)``, the
policy sampling from ``current`` and the env drawing from its per-env keys
``info["rng"]``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch

from puppax_torch import random
from puppax_torch.env.base import State
from puppax_torch.parallel import mesh as mesh_lib


@dataclass(frozen=True)
class Transition:
    observation: torch.Tensor
    action: torch.Tensor  # post-tanh action fed to the env
    reward: torch.Tensor
    discount: torch.Tensor  # 1 - done
    next_observation: torch.Tensor
    truncation: torch.Tensor  # episode cut off at the horizon (not a failure)
    policy_extras: Dict[str, torch.Tensor]  # log_prob, raw_action (pre-tanh)
    metrics: Dict[str, torch.Tensor] = field(default_factory=dict)
    extras: Dict[str, torch.Tensor] = field(default_factory=dict)


def actor_step(env, env_state: State, policy: Callable, key: torch.Tensor,
               collect_metrics: bool = False) -> Tuple[State, Transition]:
    """One policy step on a wrapped env; ``collect_metrics`` also records
    the env's per-step metrics (the evaluator's use). Where the env
    publishes privileged obs, ``extras`` holds the pre-step
    ``privileged_obs`` and the post-step ``next_privileged_obs``. The
    policy samples from ``key`` ``(2,)``; the env draws from
    ``info["rng"]``."""
    actions, policy_extras = policy(env_state.obs, key)
    next_state = env.step(env_state, actions)
    extras = {}
    if "privileged_obs" in env_state.info:
        extras = {"privileged_obs": env_state.info["privileged_obs"],
                  "next_privileged_obs": next_state.info["privileged_obs"]}
    return next_state, Transition(
        observation=env_state.obs,
        action=actions,
        reward=next_state.reward,
        discount=1.0 - next_state.done,
        next_observation=next_state.obs,
        truncation=next_state.info["truncation"],
        policy_extras=policy_extras,
        metrics=dict(next_state.metrics) if collect_metrics else {},
        extras=extras,
    )


def _stack(ts):
    if isinstance(ts[0], dict):
        return {k: _stack([t[k] for t in ts]) for k in ts[0]}
    return torch.stack(ts)


def generate_unroll(env, env_state: State, policy: Callable, key: torch.Tensor,
                    unroll_length: int, collect_metrics: bool = False
                    ) -> Tuple[State, Transition]:
    """``unroll_length`` actor steps on the key chain of
    ``puppax/train/acting.py:84-91``; returns (final state, transitions
    stacked on a leading time axis)."""
    steps = []
    for _ in range(unroll_length):
        current, key = random.split(key).unbind(0)
        env_state, transition = actor_step(env, env_state, policy, current,
                                           collect_metrics=collect_metrics)
        steps.append(transition)
    fields = {f: _stack([getattr(t, f) for t in steps])
              for f in ("observation", "action", "reward", "discount", "next_observation",
                        "truncation", "policy_extras", "metrics", "extras")}
    return env_state, Transition(**fields)


def episode_metrics(data: Transition, final_state: State, mesh=None) -> Dict[str, torch.Tensor]:
    """The evaluator's aggregation of a (T, B) eval unroll: per-episode sums
    over the steps up to and including each env's first done, averaged over
    the envs (``puppax/train/acting.py:134-159``). ``total_dist`` is a gauge,
    read at the end of the episode. With a ``parallel.EnvMesh`` over a
    process group, the unroll is the rank's share: every rank's per-env
    sums are gathered, and each metric is over the world's envs."""
    done_mask = torch.cumsum((data.discount < 0.5).to(torch.int32), dim=0)
    active = torch.cat(
        [torch.ones_like(done_mask[:1]), (done_mask < 1)[:-1].to(done_mask.dtype)], dim=0
    ).to(data.reward.dtype)
    per_env = {" reward": torch.sum(data.reward * active, dim=0),
               " length": torch.sum(active, dim=0)}
    for name, series in data.metrics.items():
        per_env[name] = (final_state.metrics[name] if name == "total_dist"
                         else torch.sum(series * active, dim=0))
    if mesh is not None and mesh.backend is not None:
        names = list(per_env)
        got = mesh_lib.all_gather(torch.stack([per_env[k] for k in names]), mesh, "eval")
        got = got.transpose(0, 1).reshape(len(names), -1)  # (metric, world's envs)
        per_env = {k: got[i].contiguous() for i, k in enumerate(names)}
    metrics = {
        "eval/episode_reward": torch.mean(per_env[" reward"]),
        # jnp.std: the population standard deviation
        "eval/episode_reward_std": torch.std(per_env[" reward"], correction=0),
        "eval/avg_episode_length": torch.mean(per_env[" length"]),
    }
    for name in data.metrics:
        key = "eval/episode_total_dist" if name == "total_dist" else f"eval/episode_{name}"
        metrics[key] = torch.mean(per_env[name])
    return metrics


def shard_policy(policy: Callable, mesh, num_envs: int, action_size: int) -> Callable:
    """A rank's sampling policy over its share of ``num_envs`` envs: the
    ``(num_envs, act)`` normal draw from the step's key is the world's, and
    the rank samples from its rows (as the JAX package's one draw over the
    sharded batch). A world of one returns ``policy``."""
    if mesh is None or mesh.world == 1:
        return policy
    rows = mesh_lib.env_sharding(mesh, num_envs)

    def sharded(obs: torch.Tensor, key: torch.Tensor):
        eps = random.normal(key.to(obs.device), (num_envs, action_size))[rows]
        return policy(obs, eps=eps)

    return sharded


class Evaluator:
    """Runs full eval episodes on a wrapped eval env (reset with its
    physics caches, stepped through K2) and aggregates episode metrics. It
    runs on its env's device (``cuda:0`` unless the env was built for
    another). Each evaluation splits its key from the evaluator's chain,
    then the reset keys and the unroll's key from it
    (``puppax/train/acting.py:120-124, 164``). A rank's evaluator
    (``mesh=``, a ``parallel.EnvMesh``) runs its share of the
    ``num_eval_envs`` envs (its policy samples as ``shard_policy`` does)
    and reduces the metrics over the world's."""

    def __init__(self, eval_env, eval_policy_factory: Callable, num_eval_envs: int,
                 episode_length: int, action_repeat: int, key: torch.Tensor, mesh=None):
        self._env = eval_env
        self._policy_factory = eval_policy_factory
        self._num_eval_envs = int(num_eval_envs)
        self._mesh = mesh
        self._episode_steps = episode_length // action_repeat
        self._key = key
        self._eval_walltime = 0.0

    def next_keys(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Advance the chain: (the reset keys ``(num_eval_envs, 2)``, the
        unroll's key ``(2,)``) of the next evaluation; a rank's evaluator
        (``mesh=``) keeps its share of the reset keys."""
        self._key, eval_key = random.split(self._key).unbind(0)
        key_reset, key_unroll = random.split(eval_key).unbind(0)
        keys = random.split(key_reset, self._num_eval_envs)
        if self._mesh is not None:
            keys = keys[mesh_lib.env_sharding(self._mesh, self._num_eval_envs)]
        return keys, key_unroll

    @torch.no_grad()
    def run_evaluation(self, policy_params) -> Dict[str, float]:
        t = time.perf_counter()
        reset_keys, key_unroll = self.next_keys()
        state = self._env.reset(reset_keys, caches=True)
        policy = self._policy_factory(policy_params)
        final_state, data = generate_unroll(self._env, state, policy, key_unroll,
                                            self._episode_steps, collect_metrics=True)
        metrics = {k: float(v)
                   for k, v in episode_metrics(data, final_state, self._mesh).items()}
        epoch_time = time.perf_counter() - t
        self._eval_walltime += epoch_time
        metrics["eval/walltime"] = self._eval_walltime
        metrics["eval/epoch_eval_time"] = epoch_time
        return metrics
