"""The training wrapper stack: Episode + DR batch + AutoReset.

Counterpart of ``puppax/env/wrappers.py::wrap_for_training``: the JAX
stack AutoReset(Vmap(Episode(env))) as one class over a batched env.

* Reset adds the Episode ``steps`` and ``truncation`` fields and the
  AutoReset ``first_qpos`` / ``first_qvel`` / ``first_obs`` rows (and
  ``first_privileged_obs`` where the env publishes privileged obs); with
  ``caches=True`` (the standard lane) it also runs the reset-time forward
  pass (``pipeline.pipeline_init`` of the DR batch) and keeps it as
  ``first_pipeline_state``.
* The step side (``step`` / ``step_from_draws``) runs the brax order
  around ``PupperV3Env.step_from_draws``: the AutoReset prologue zeroes
  ``steps`` where the previous step ended, the Episode wrapper steps the
  env ``action_repeat`` times, sums their rewards, counts the steps and
  truncates at the episode limit, and on the effective done AutoReset
  restores the reset-time pipeline state, qpos, qvel, observation and
  privileged obs and restarts the gait clock.
* The DR batch is the per-env model, which the env's physics reads; its
  parameter rows (``dr_rows``) are the kernels' dr block, which the start
  of a run is checked against. An unbatched model is broadcast.

The kernels run the same step side (the wrapped-step kernel K3, the fused
unroll K4).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from refport.env.base import State


class TrainingEnv:
    """AutoReset(Vmap(Episode(env))) over a batched ``PupperV3Env``."""

    def __init__(self, env, episode_length: int, model, num_envs: Optional[int],
                 action_repeat: int = 1):
        self.env = env
        self.episode_length = int(episode_length)
        self.action_repeat = int(action_repeat)
        self.model = model  # base model, or the DR-batched one
        self.num_envs = num_envs  # fixed by DR; None = any batch size
        self._dr_rows: Dict[int, torch.Tensor] = {}

    def dr_rows(self, B: int) -> torch.Tensor:
        """The ``(ndr, B)`` parameter rows of the (DR-batched) model. With
        privileged rows in the kernels, the friction leaf they read
        (pair_mu[0]) must equal every env's ``geom_friction[0, 0]``, which
        the standard lane reads: checked here, once per batch size."""
        if B not in self._dr_rows:
            rows = self.env.dr_rows(B, self.model)
            es = self.env._es
            if es.priv:
                r0, _ = self.env._s.dr_rows["pair_mu"]
                leaf = torch.as_tensor(self.model.geom_friction[..., 0, 0], dtype=torch.float32,
                                       device=rows.device).expand(B)
                if not torch.equal(rows[r0], leaf):
                    raise ValueError("privileged rows: pair 0's friction differs from "
                                     "geom_friction[0, 0]; DR must set one friction on every geom")
            self._dr_rows[B] = rows
        return self._dr_rows[B]

    def reset(self, keys: torch.Tensor, caches: bool = False) -> State:
        """Reset one env per key of ``keys`` ``(B, 2)`` (the JAX stack's
        ``reset(jax.random.split(key, B))``)."""
        if self.num_envs is not None and keys.shape[0] != self.num_envs:
            raise ValueError(
                f"the DR model is batched for {self.num_envs} envs, not {keys.shape[0]}"
            )
        return self.reset_from_draws(self.env.draw_reset(keys), caches)

    def reset_from_draws(self, draws, caches: bool = False) -> State:
        """Reset on given draws; ``caches=True`` adds the reset-time
        physics caches the standard lane restores on done."""
        state = self.env.reset_from_draws(draws, self.model)
        info = dict(state.info)
        # EpisodeWrapper
        info["steps"] = torch.zeros_like(state.reward)
        info["truncation"] = torch.zeros_like(state.reward)
        # AutoResetWrapper
        info["first_qpos"] = state.qpos
        info["first_qvel"] = state.qvel
        info["first_obs"] = state.obs
        if "privileged_obs" in info:
            info["first_privileged_obs"] = info["privileged_obs"]
        pipeline_state = None
        if caches:
            pipeline_state = self.env.pipeline_init(state.qpos, state.qvel, self.model)
            info["first_pipeline_state"] = pipeline_state
        return state.replace(info=info, pipeline_state=pipeline_state)

    def step(self, state: State, action: torch.Tensor) -> State:
        """One wrapped step of every env (``action_repeat`` env steps), each
        env step's draws made from ``info["rng"]`` in turn."""
        keys, noise = state.info["rng"], []
        for _ in range(self.action_repeat):
            noise.append(self.env.draw_step_noise(keys))
            keys = noise[-1]["rng"]
        return self.step_from_draws(state, action, noise[0] if len(noise) == 1 else noise)

    def step_from_draws(self, state: State, action: torch.Tensor,
                        noise: Union[Dict[str, torch.Tensor], Sequence[Dict]]) -> State:
        """The wrapped step on given draws (``puppax/env/wrappers.py:45-70,
        129-169``): ``noise`` is one step's draws, or with ``action_repeat``
        above 1 a sequence of that many."""
        if "first_pipeline_state" not in state.info:
            raise ValueError("the standard lane steps a state reset with caches=True")
        noises = [noise] if isinstance(noise, dict) else list(noise)
        if len(noises) != self.action_repeat:
            raise ValueError(f"{len(noises)} steps of draws for action_repeat="
                             f"{self.action_repeat}")
        # AutoResetWrapper prologue
        info = dict(state.info)
        info["steps"] = torch.where(state.done > 0.5, torch.zeros_like(info["steps"]),
                                    info["steps"])
        state = state.replace(done=torch.zeros_like(state.done), info=info)
        # EpisodeWrapper: the env steps action_repeat times, its rewards summed
        reward = None
        for n in noises:
            state = self.env.step_from_draws(state, action, n, None, self.model)
            reward = state.reward if reward is None else reward + state.reward
        state = state.replace(reward=reward)
        info = dict(state.info)
        steps = info["steps"] + self.action_repeat
        limit = steps >= self.episode_length
        info["truncation"] = torch.where(limit, 1.0 - state.done, torch.zeros_like(state.done))
        info["steps"] = steps
        done = torch.where(limit, torch.ones_like(state.done), state.done)
        # AutoResetWrapper: restore the reset-time state on the effective done
        on_done = done > 0.5

        def restore(first, new):
            return torch.where(on_done.reshape((-1,) + (1,) * (new.ndim - 1)), first, new)

        ps = info["first_pipeline_state"].map(restore, state.pipeline_state)
        if "gait_phase" in info:  # the gait clock restarts with the episode
            info["gait_phase"] = restore(torch.zeros_like(info["gait_phase"]),
                                         info["gait_phase"])
        if "privileged_obs" in info:
            info["privileged_obs"] = restore(info["first_privileged_obs"], info["privileged_obs"])
        return state.replace(qpos=ps.qpos, qvel=ps.qvel, pipeline_state=ps,
                             obs=restore(info["first_obs"], state.obs), done=done, info=info)


def wrap_for_training(
    env,
    episode_length: int = 1000,
    action_repeat: int = 1,
    randomization_fn: Optional[Callable] = None,
    randomization_keys: Optional[torch.Tensor] = None,
) -> TrainingEnv:
    """Episode + (DR-)batch + AutoReset. ``randomization_fn(model, keys)
    -> model`` batches the DR leaves over the envs, one per key of
    ``randomization_keys`` ``(B, 2)`` (``puppax/env/wrappers.py:172-186``)."""
    model = env.model
    num_envs = None
    if randomization_fn is not None:
        if randomization_keys is None:
            raise ValueError("domain randomization needs its per-env keys")
        model = randomization_fn(model, randomization_keys)
        num_envs = int(randomization_keys.shape[0])
    return TrainingEnv(env, episode_length, model, num_envs, action_repeat)
