"""The rollout fast lane: T policy steps through the wrapped-step kernel.

Counterpart of ``puppax/env/rollout.py::FastLane``. The unroll carry stays
in the kernel's layout for all T steps: every carry array is ``(rows, B)``
row-major float32 (qpos, qvel, the flattened env-state block, the 2-row
wrapper block of episode steps and previous done, the gait clock's phase
row when the clock is on, the reset-time ``first_*`` rows and the DR
parameter rows). The lane runs one of two ways:

* by default, a Python loop of T steps, each the policy MLP + NormalTanh
  sample on the observation rows (``policy_rows``: ``torch.matmul`` in
  full float32, feature-major) and one fused wrapped env step
  (``soa_env.wrapped_step``, team K3): auto-reset prologue, kick, action
  latency, physics, observation, rewards, termination and episode
  bookkeeping in one kernel launch; then the gait clock's tick;
* with ``PUPPAX_FUSED_UNROLL=on`` (``use_fused``), the whole unroll in one
  launch of the fused unroll K4 (``env/fused_unroll.py``): the same steps
  with the observation normalizer folded into the policy's first layer.

Both share ``_assemble_unroll``. Every random number is drawn before the
loop, as the JAX lane draws it: the env noise on the envs' key chains
(``draw_noise_block``) and the sampling eps from the unroll's key
(``draw_eps``), so ``unroll`` from the same keys is seed for seed the JAX
lane's, and ``unroll_from_draws`` can be fed given draws. The disturbance
curriculum's difficulty scales those draws where they enter the lane
(``unroll_from_draws``), as the JAX env scales its own. Where the env publishes privileged obs, the kernels emit them as
aux rows, restored on done from the ``first`` block, and the transitions
carry them in ``extras`` as ``acting.actor_step`` records them.

The JAX lane's TPU devices (the ``(rows, B/128, 128)`` tiles, padding B
to 1024) have no counterpart here; the JAX ``scan`` is a Python loop
around K3, or the loop inside K4. Its ``shard_map`` over the env axis is
a rank's lane (``FastLane(wrapped, mesh=)``, one process per GPU): the
rank steps its own envs and draws the eps for the world's.

``support_reason`` says whether ``ppo.train`` takes this lane or unrolls
the standard lane (``acting.generate_unroll``), and why.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from puppax_torch import random
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.env.base import State
from puppax_torch.env.pupper import DISTURBANCE_KEYS
from puppax_torch.env.wrappers import TrainingEnv
from puppax_torch.parallel import mesh as mesh_lib
from puppax_torch.physics import soa
from puppax_torch.train.acting import Transition
from puppax_torch.train.distribution import NormalTanhDistribution


def support_reason(wrapped: TrainingEnv) -> Tuple[bool, str]:
    """(ok, reason): whether the fast lane can run this wrapped env with
    standard-lane-equal semantics, and why not when it cannot
    (``puppax/env/rollout.py:63-102``, for the reasons the port knows)."""
    if os.environ.get("PUPPAX_SOA_ENV", "auto") == "off":
        return False, "PUPPAX_SOA_ENV=off"
    if os.environ.get("PUPPAX_FAST_LANE", "auto") == "off":
        return False, "PUPPAX_FAST_LANE=off"
    if not wrapped.env._use_soa_env:
        return False, ("env built without the fused SoA step core "
                       "(PUPPAX_SOA_ENV=off at its construction)")
    if wrapped.env._privileged_obs and not wrapped.env._es.priv:
        # the kernel cannot read this model's friction leaf (soa_env._EnvStatic)
        return False, ("privileged_obs requested but the kernel cannot source this "
                       "model's privileged DR rows")
    if wrapped.action_repeat != 1:
        return False, f"action_repeat={wrapped.action_repeat} (kernel fuses 1)"
    return True, "ok"


def scale_noise_block(es: soa_env._EnvStatic, noise: torch.Tensor,
                      difficulty: torch.Tensor) -> torch.Tensor:
    """A ``(T, nnoise, B)`` noise block with its disturbance rows
    (``pupper.DISTURBANCE_KEYS``) times the per-env ``difficulty`` ``(B,)``."""
    scale = torch.ones((noise.shape[1], noise.shape[2]), dtype=noise.dtype, device=noise.device)
    for name in DISTURBANCE_KEYS:
        r0, n = es.noise_rows[name]
        scale[r0 : r0 + n] = difficulty
    return noise * scale


class FastLane:
    """The fast-lane unroll for one wrapped training env."""

    def __init__(self, wrapped: TrainingEnv, mesh=None):
        env = wrapped.env
        # a rank's lane (``parallel.EnvMesh``): its envs are its share of
        # the world's, and the sampling eps are drawn for all of them
        self.mesh = mesh
        self.env = env
        self.wrapped = wrapped
        self.device = env.device
        self.episode_length = wrapped.episode_length
        self.n_substeps = env._n_substeps
        self.s: soa._Static = env._s
        self.es: soa_env._EnvStatic = env._es
        self._aux_rows = soa_env.aux_row_map(self.es)
        # the gait clock (pupper.py:754-767) rides outside the step: the lane
        # carries its phase as a row and appends (cos, sin) to the observation
        self.gait = bool(env._gait_phase_obs)
        self.obs_dim = self.es.hist + (2 if self.gait else 0)
        self.priv = bool(self.es.priv)
        if env._privileged_obs and not self.priv:
            raise ValueError("the fast lane needs the kernels' privileged rows")
        self._dist = NormalTanhDistribution(env.action_size)
        # full float32 policy dots: the counterpart of the JAX lane's
        # Precision.HIGHEST (a TF32 product keeps ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ---- layout helpers -----------------------------------------------------
    def carry_from_state(self, state: State) -> Dict[str, torch.Tensor]:
        """State -> the ``(rows, B)`` carry blocks."""
        es, info = self.es, state.info
        rows = soa_env.rows_block
        return {
            "q": rows([state.qpos]),
            "v": rows([state.qvel]),
            "env": soa_env.env_block(es, info, state.obs),
            "wrap": rows([info["steps"], state.done]),
            "first": rows([info["first_qpos"], info["first_qvel"], info["first_obs"][:, : es.hist]]
                          + ([info["first_privileged_obs"]] if self.priv else [])),
            "dr": self.wrapped.dr_rows(state.qpos.shape[0]),
            **({"phase": rows([info["gait_phase"]])} if self.gait else {}),
        }

    def _full_obs(self, env_rows: torch.Tensor, phase) -> torch.Tensor:
        """The policy observation rows: the history rows of an env block,
        then the clock's (cos, sin) of a ``(1, B)`` phase when it is on."""
        r0, n = self.es.env_rows["obs_history"]
        obs = env_rows[r0 : r0 + n]
        if not self.gait:
            return obs
        return torch.cat([obs, torch.cos(phase), torch.sin(phase)])

    def state_from_carry(self, carry, template: State, last_kick, last_aux) -> State:
        """The carry blocks -> State (the JAX step's epilogue plus the
        wrapper info fields); ``template`` supplies the untouched fields."""
        es = self.es
        B = carry["q"].shape[1]
        env_b = carry["env"].t()
        aux_b = last_aux.t()

        def rows(name):
            r0, n = es.env_rows[name]
            return env_b[:, r0 : r0 + n]

        def aux(name):
            r0, n = self._aux_rows[name]
            return aux_b[:, r0 : r0 + n]

        info = dict(template.info)
        info["action_buffer"] = rows("action_buffer").reshape(B, 12, es.Da)
        info["imu_buffer"] = rows("imu_buffer").reshape(B, 6, es.Di)
        info["command"] = rows("command")
        info["desired_world_z_in_body_frame"] = rows("desired_z")
        info["last_act"] = rows("last_act")
        info["last_vel"] = rows("last_vel")
        info["feet_air_time"] = rows("feet_air_time")
        info["last_contact"] = rows("last_contact") > 0.5
        info["step"] = rows("step")[:, 0].to(torch.int32)
        info["steps"] = carry["wrap"][0]
        info["truncation"] = aux("truncation")[:, 0]
        info["kick"] = last_kick
        info["rewards"] = {k: aux("rewards")[:, i] for i, k in enumerate(soa_env.REWARD_ORDER)}
        if self.priv:
            info["privileged_obs"] = aux("privileged")
        if self.gait:
            info["gait_phase"] = carry["phase"][0]
        metrics = dict(template.metrics)
        metrics["total_dist"] = aux("total_dist")[:, 0]
        metrics.update(info["rewards"])
        return template.replace(
            qpos=carry["q"].t(),
            qvel=carry["v"].t(),
            obs=self._full_obs(carry["env"], carry.get("phase")).t(),
            reward=aux("reward")[:, 0],
            done=aux("done")[:, 0],
            metrics=metrics,
            info=info,
            pipeline_state=None,
        )

    # ---- pre-drawn randomness -------------------------------------------------
    def draw_noise_block(self, keys: torch.Tensor, T: int):
        """Every env-noise row for T steps on the envs' key chains
        (``puppax/env/rollout.py:366-404``: T ``draw_step_noise`` calls in
        turn, batched over the envs' ``(B, 2)`` keys). Returns the keys
        after T steps, the ``(T, nnoise, B)`` block and the last step's kick
        ``(B, 2)``."""
        block, kick = [], None
        for _ in range(T):
            noise = self.env.draw_step_noise(keys)
            keys = noise["rng"]
            block.append(soa_env.noise_block(self.es, noise))
            kick = noise["kick"]
        return keys, torch.stack(block), kick

    def draw_eps(self, key: torch.Tensor, B: int, T: int) -> torch.Tensor:
        """The policy's sampling eps ``(T, B, act)`` from one ``(2,)`` key:
        per step ``cur, nxt = split(key)`` and ``normal(cur, (B, act))``
        (``puppax/env/rollout.py:496-503``), the T normals in one draw. A
        rank's lane draws them for the world's ``B * world`` envs and keeps
        its rows ("drawn OUTSIDE the sharded body", ``rollout.py:489-505``)."""
        used = []
        for _ in range(T):
            cur, key = random.split(key).unbind(0)
            used.append(cur)
        world = 1 if self.mesh is None else self.mesh.world
        eps = random.normal(torch.stack(used), (B * world, self.env.action_size))
        if world == 1:
            return eps
        return eps[:, mesh_lib.env_sharding(self.mesh, B * world)]

    # ---- the policy in feature-major layout ---------------------------------------
    def policy_rows(self, normalizer, policy):
        """Feature-major policy apply: obs rows ``(obs, B)`` + eps rows
        ``(act, B)`` -> action, raw (pre-tanh) action ``(act, B)`` and
        log_prob ``(B,)``; the same math as the batch-major policy
        network + ``NormalTanhDistribution``."""
        layers = [(layer.weight, layer.bias) for layer in policy.layers()]
        act_n = self.env.action_size
        dist = self._dist

        def apply(obs_rows, eps_rows):
            x = obs_rows
            if normalizer is not None:
                x = (x - normalizer.mean[:, None]) / normalizer.std[:, None]
            for i, (w, b) in enumerate(layers):
                x = torch.matmul(w, x) + b[:, None]
                if i != len(layers) - 1:
                    # over each env's features, as the batch-major network
                    # (a softmax over the rows' last axis would mix envs)
                    x = policy.activation(x.t()).t()
            loc, scale = x[:act_n], F.softplus(x[act_n:]) + dist._min_std
            pre_tanh = loc + scale * eps_rows
            log_prob = dist.log_prob_from(loc, scale, pre_tanh, dim=0)
            return torch.tanh(pre_tanh).contiguous(), pre_tanh, log_prob

        return apply

    # ---- the unroll ------------------------------------------------------------
    def use_fused(self, T: int) -> bool:
        """Whether ``unroll`` runs the fused unroll K4 (one launch per
        unroll) instead of T K3 launches: ``PUPPAX_FUSED_UNROLL`` in
        ``on``/``force``/``auto_on``, read at each call. Off by default, as
        in the JAX package (``rollout.py:459-475``)."""
        return os.environ.get("PUPPAX_FUSED_UNROLL", "off") in ("on", "force", "auto_on") and T >= 1

    def unroll(self, state: State, policy_params: Tuple, key: torch.Tensor, T: int):
        """T policy steps from ``state``; returns (final State, Transition
        stack). ``policy_params`` is (normalizer state, policy ``MLP``);
        ``key`` ``(2,)`` draws the sampling eps, and the env noise comes
        from the state's per-env keys ``info["rng"]``, which the final state
        carries on."""
        B = state.qpos.shape[0]
        eps = self.draw_eps(key, B, T)
        keys, noise, last_kick = self.draw_noise_block(state.info["rng"], T)
        final, data = self.unroll_from_draws(state, policy_params, noise, eps, last_kick)
        return final.replace(info={**final.info, "rng": keys}), data

    @torch.no_grad()
    def unroll_from_draws(self, state: State, policy_params: Tuple, noise: torch.Tensor,
                          eps: torch.Tensor, last_kick: torch.Tensor):
        """The unroll on given draws: ``noise`` ``(T, nnoise, B)`` env-noise
        rows, ``eps`` ``(T, B, act)`` sampling eps, ``last_kick`` ``(B, 2)``;
        the state's difficulty, where it has one, scales the noise rows and
        the kick here."""
        normalizer, policy = policy_params
        carry = self.carry_from_state(state)
        T = noise.shape[0]
        if "difficulty" in state.info:
            d = state.info["difficulty"]
            noise = scale_noise_block(self.es, noise, d)
            last_kick = last_kick * d[:, None]
        if self.use_fused(T):
            # K4 on CUDA tensors, its plain version on CPU tensors
            (q, v, env_t, wrap, phase, obs_ts, act_ts, raw_ts, logp_ts,
             aux_ts) = fused_unroll.unroll(
                self.s, self.es, self.n_substeps, self.episode_length, policy.activation_name,
                fused_unroll.fold_normalizer(normalizer, policy), carry["q"], carry["v"],
                carry["env"], carry["wrap"], carry.get("phase"), carry["first"], carry["dr"],
                noise, eps.transpose(1, 2).contiguous())
            carry.update(q=q, v=v, env=env_t, wrap=wrap, phase=phase)
            return self._assemble_unroll(state, carry, obs_ts, act_ts, raw_ts, logp_ts[:, 0],
                                         aux_ts, last_kick)
        papply = self.policy_rows(normalizer, policy)
        done_r0 = self._aux_rows["done"][0]
        q, v, env_t, wrap = carry["q"], carry["v"], carry["env"], carry["wrap"]
        phase = carry.get("phase")
        ys = []
        for t in range(T):
            obs_t = self._full_obs(env_t, phase)
            act, raw, logp = papply(obs_t, eps[t].t())
            # the kernel on CUDA tensors, its plain version on CPU tensors
            q, v, env_t, wrap, aux = soa_env.wrapped_step(
                self.s, self.es, self.n_substeps, self.episode_length,
                q, v, act, env_t, noise[t], carry["dr"], carry["first"], wrap,
            )
            if self.gait:
                phase = soa_env.tick_gait_clock(phase, self.es.dphase, aux[done_r0 : done_r0 + 1])
            ys.append((obs_t, act, raw, logp, aux))
        carry.update(q=q, v=v, env=env_t, wrap=wrap, phase=phase)
        obs_ts, act_ts, raw_ts, logp_ts, aux_ts = (torch.stack(x) for x in zip(*ys))
        return self._assemble_unroll(state, carry, obs_ts, act_ts, raw_ts, logp_ts, aux_ts,
                                     last_kick)

    def _assemble_unroll(self, state: State, carry, obs_ts, act_ts, raw_ts, logp_ts, aux_ts,
                         last_kick):
        """Per-step ``(T, rows, B)`` outputs (``logp_ts`` ``(T, B)``) ->
        (final State, time-major Transition): the epilogue of both ways."""

        def t_rows(x):  # (T, rows, B) -> (T, B, rows)
            return x.transpose(1, 2)

        observation = t_rows(obs_ts)
        final_obs = self._full_obs(carry["env"], carry.get("phase")).t()
        next_observation = torch.cat([observation[1:], final_obs[None]], 0)
        aux_b = t_rows(aux_ts)  # (T, B, naux)

        def aux_col(name):
            r0, _ = self._aux_rows[name]
            return aux_b[:, :, r0]

        done = aux_col("done")
        extras = {}
        if self.priv:
            # acting.actor_step's extras: privileged_obs is the pre-step
            # value (the entry state's at t = 0, then the previous step's
            # post-restore rows), next_privileged_obs the post-step value
            r0, n = self._aux_rows["privileged"]
            priv = aux_b[:, :, r0 : r0 + n]
            extras = {"privileged_obs": torch.cat([state.info["privileged_obs"][None], priv[:-1]]),
                      "next_privileged_obs": priv}
        final_state = self.state_from_carry(carry, state, last_kick, aux_ts[-1])
        data = Transition(
            observation=observation,
            action=t_rows(act_ts),
            reward=aux_col("reward"),
            discount=1.0 - done,
            next_observation=next_observation,
            truncation=aux_col("truncation"),
            policy_extras={"log_prob": logp_ts, "raw_action": t_rows(raw_ts)},
            extras=extras,
        )
        return final_state, data
