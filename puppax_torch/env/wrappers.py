"""The training wrapper stack: Episode + DR batch + AutoReset, reset side.

Counterpart of ``puppax/env/wrappers.py::wrap_for_training``. The JAX
stack is AutoReset(Vmap(Episode(env))); its STEP side (episode step
count, truncation, restore of qpos/qvel/obs from the reset-time rows on
done) runs inside the wrapped-step kernel (``soa_env._emit_wrapped_step``),
so this module holds only what reset adds: the Episode ``steps`` and
``truncation`` fields, the batched DR model, and the AutoReset
``first_qpos`` / ``first_qvel`` / ``first_obs`` rows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from puppax_torch.env.base import State


class TrainingEnv:
    """AutoReset(Vmap(Episode(env))) for the rollout fast lane."""

    def __init__(self, env, episode_length: int, model, num_envs: Optional[int]):
        self.env = env
        self.episode_length = int(episode_length)
        self.model = model  # base model, or the DR-batched one
        self.num_envs = num_envs  # fixed by DR; None = any batch size

    def reset(self, num_envs: int, generator: torch.Generator) -> State:
        if self.num_envs is not None and num_envs != self.num_envs:
            raise ValueError(
                f"the DR model is batched for {self.num_envs} envs, not {num_envs}"
            )
        return self.reset_from_draws(self.env.draw_reset(generator, num_envs))

    def reset_from_draws(self, draws) -> State:
        state = self.env.reset_from_draws(draws)
        info = dict(state.info)
        # EpisodeWrapper
        info["steps"] = torch.zeros_like(state.reward)
        info["truncation"] = torch.zeros_like(state.reward)
        # AutoResetWrapper
        info["first_qpos"] = state.qpos
        info["first_qvel"] = state.qvel
        info["first_obs"] = state.obs
        return state.replace(info=info)


def wrap_for_training(
    env,
    episode_length: int = 1000,
    action_repeat: int = 1,
    randomization_fn: Optional[Callable] = None,
    generator: Optional[torch.Generator] = None,
    num_envs: Optional[int] = None,
) -> TrainingEnv:
    """Episode + (DR-)batch + AutoReset. ``randomization_fn(model,
    generator, num_envs) -> model`` batches the DR leaves over
    ``num_envs`` envs with draws from ``generator``."""
    if action_repeat != 1:
        raise NotImplementedError(
            "action_repeat != 1 (the wrapped-step kernel fuses one env step; "
            "ROADMAP queue 1, training extras)"
        )
    model = env.model
    if randomization_fn is not None:
        if generator is None or num_envs is None:
            raise ValueError("domain randomization needs a generator and num_envs")
        model = randomization_fn(model, generator, num_envs)
    return TrainingEnv(env, episode_length, model,
                       num_envs if randomization_fn is not None else None)
