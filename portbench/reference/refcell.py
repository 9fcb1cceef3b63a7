"""The plain reference of a cell, made from the seed and the configuration
alone: keys, env, domain randomization, reset, the policy's weights, the
draws, the policy and the wrapped env step, all from ``refport`` (the
frozen plain copy beside this file).

The env step is ``PupperV3Env._step_core`` around ``pipeline_step``
(``smooth``, ``collision``, ``constraint``, ``solver``) in float64, with
the episode and auto-reset wrapper of ``TrainingEnv.step_from_draws``:
another implementation than the kernels' emission, with the contact caps
raised to every pair, as the kernels evaluate them (``pipeline.uncapped``).

It follows the program step by step: at each env step it checks, it takes
the program's env state there (qpos, qvel, the env rows, the ``first``
rows, the episode rows) and works out the rest itself: the action from its
own weights and its own sampling draws (or, on a step of the training
cell's window, where its weights are not the program's, the program's
action), the env noise from its own key chains and the DR'd model from its
own keys, then the step. The start of those chains (keys, DR, reset,
weights) is checked on its own (``start_blocks``).
"""

from __future__ import annotations

import copy
import functools
import os
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from refport import random  # noqa: E402
from refport.configs import experiment as exp  # noqa: E402
from refport.configs import get_config  # noqa: E402
from refport.env import soa_env  # noqa: E402
from refport.env.base import State  # noqa: E402
from refport.env.domain_randomization import domain_randomize  # noqa: E402
from refport.env.pupper import PupperV3Env  # noqa: E402
from refport.env.wrappers import TrainingEnv, wrap_for_training  # noqa: E402
from refport.model.mjcf import LEAF_FIELDS  # noqa: E402
from refport.physics import pipeline  # noqa: E402
from refport.train import networks, running_statistics  # noqa: E402

F64 = torch.float64
# device memory one block of the float64 step may take: the solver's line
# search holds a few (items, 3 nefc + 1, nefc) tensors
STEP_BLOCK_BYTES = {"cuda": 32 << 30, "cpu": 1 << 29}


def init_keys(seed: int, num_envs: int, randomize: bool, device) -> Dict[str, torch.Tensor]:
    """The learner's key tree for a seed (``ppo.init_keys``)."""
    key, network_key, env_key, eval_key = random.split(random.key(seed, device), 4).unbind(0)
    out = {"network": network_key, "eval": eval_key}
    if randomize:
        key, key_dr = random.split(key).unbind(0)
        out["dr"] = random.split(key_dr, num_envs)
    out["key"] = key
    out["env"] = random.split(env_key, num_envs)
    return out


def split2(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    a, b = random.split(key).unbind(0)
    return a, b


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through bfloat16 (floating tensors only)."""
    return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x


class Reference:
    """One cell's reference for the recorded envs ``cols`` of ``num_envs``,
    on ``device``."""

    def __init__(self, config: Dict, num_envs: int, seed: int, cols: torch.Tensor,
                 device="cpu"):
        device = torch.device(device)
        cfg = exp.from_dict(config["experiment"])
        self.cfg, self.B, self.device = cfg, num_envs, device
        t = cfg.train
        self.T, self.L = t.unroll_length, t.episode_length
        self.env = env = PupperV3Env.from_config(cfg.env, reward_config=get_config(),
                                                 device=device)
        dr = cfg.domain_randomization
        self.keys = init_keys(seed, num_envs, dr.enabled, device)
        # every env's DR, reset and key chain are its own: the reference
        # makes those of the recorded envs ``cols`` alone
        self.cols = cols.to(device)
        fn = None
        if dr.enabled:
            ranges = {k: v for k, v in exp.to_dict(dr).items() if k != "enabled"}
            fn = functools.partial(domain_randomize, **ranges)
        self.wrapped = wrap_for_training(
            env, self.L, randomization_fn=fn,
            randomization_keys=self.keys["dr"][self.cols] if dr.enabled else None)
        self.es = env._es
        self.aux_rows = soa_env.aux_row_map(self.es)
        self.reset = self.wrapped.reset(self.keys["env"][self.cols])
        self.dr = self.wrapped.dr_rows(len(self.cols))
        self.model = pipeline.uncapped(self.wrapped.model)
        # the step's env: the same env with its constants in float64
        self.step_env = copy.copy(env)
        self.step_env._dev = {k: x.to(F64) if x.is_floating_point() else x
                              for k, x in env._dev.items()}
        self.nets = networks.make_ppo_networks(
            env.observation_size, env.action_size, t.policy_hidden_layer_sizes,
            t.value_hidden_layer_sizes, t.activation, device=device,
            key=self.keys["network"], value_precision=t.value_precision)
        self.normalizer = running_statistics.init_state(env.observation_size, device)
        self.act_size = env.action_size

    # ---- the start ------------------------------------------------------
    def start_blocks(self) -> Dict[str, torch.Tensor]:
        """The recorded envs' reset state as the fast lane lays it out
        (``FastLane.carry_from_state``), their DR rows and keys."""
        st, es = self.reset, self.es
        info = st.info
        rows = soa_env.rows_block
        return {
            "q": rows([st.qpos]),
            "v": rows([st.qvel]),
            "env": soa_env.env_block(es, info, st.obs),
            "wrap": rows([info["steps"], st.done]),
            "first": rows([info["first_qpos"], info["first_qvel"], info["first_obs"][:, : es.hist]]),
            "dr": self.dr,
            "rng": info["rng"],
        }

    # ---- the draws ------------------------------------------------------
    def rng_after(self, steps: int) -> torch.Tensor:
        """The recorded envs' env-noise keys after ``steps`` env steps: each
        step's draws take ``split(keys, 5)``, the observation's draws
        ``split(k[:, 0], 6)``, and the next step's keys are the first of
        those (``PupperV3Env.draw_step_noise``)."""
        keys = self.reset.info["rng"]
        for _ in range(steps):
            keys = random.split(random.split(keys, 5)[:, 0], 6)[:, 0]
        return keys

    def noise(self, keys: torch.Tensor, T: int) -> List[Dict[str, torch.Tensor]]:
        """The env-noise draws of T steps from ``keys``, one dict of
        ``(n, k)`` rows a step."""
        out = []
        for _ in range(T):
            noise = self.env.draw_step_noise(keys)
            keys = noise["rng"]
            out.append({k: noise[k] for k in self.es.noise_rows})
        return out

    def eps(self, key: torch.Tensor, T: int) -> torch.Tensor:
        """The unroll's sampling draws ``(T, B, act)`` from its key (per step
        ``cur, key = split(key)``, the T normals in one draw)."""
        used = []
        key = key.to(self.device)
        for _ in range(T):
            cur, key = split2(key)
            used.append(cur)
        return random.normal(torch.stack(used), (self.B, self.act_size))

    # ---- the policy -------------------------------------------------------
    @torch.no_grad()
    def policy_rows(self, obs_rows: torch.Tensor, eps_rows: torch.Tensor, normalizer=None,
                    policy=None):
        """Action, pre-tanh action ``(act, n)`` and log-prob ``(n,)`` of
        ``(obs, n)`` observation rows and ``(act, n)`` draws."""
        normalizer = self.normalizer if normalizer is None else normalizer
        policy = self.nets.policy_network if policy is None else policy
        dist = self.nets.action_distribution
        x = obs_rows.to(self.device).t()
        x = (x - normalizer.mean) / normalizer.std
        logits = policy(x).t()
        loc = logits[: self.act_size]
        scale = F.softplus(logits[self.act_size:]) + dist._min_std
        pre = loc + scale * eps_rows.to(self.device)
        logp = dist.log_prob_from(loc, scale, pre, dim=0)
        return torch.tanh(pre), pre, logp

    # ---- the env step -----------------------------------------------------
    def _items_model(self, envs: torch.Tensor):
        """The DR'd model of each item's env (``envs``: positions in
        ``cols``), its per-env leaves taken in item order."""
        base = self.env.model
        taken = {}
        for name in LEAF_FIELDS:
            leaf = getattr(self.model, name)
            if (isinstance(leaf, torch.Tensor)
                    and tuple(leaf.shape) != tuple(np.shape(getattr(base, name)))):
                taken[name] = leaf[envs.to(leaf.device)]
        return self.model.replace(**taken)

    def _block_items(self) -> int:
        """Items in one block of the float64 step."""
        m = self.model
        nefc = m.nv + m.njnt + 4 * pipeline.npair(m)
        per_item = 8 * 6 * (3 * nefc + 1) * nefc
        return max(1, STEP_BLOCK_BYTES[self.device.type] // per_item)

    @torch.no_grad()
    def step(self, ins: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor],
             envs: torch.Tensor, rounding=None) -> Tuple[torch.Tensor, ...]:
        """The plain wrapped step of ``n`` items in float64, in blocks:
        ``ins`` the input rows ``q``, ``v``, ``act``, ``env``, ``first``,
        ``wrap`` (``(rows, n)``, the fast lane's layout), ``noise`` the
        draws (``(n, k)`` each), ``envs`` each item's position in ``cols``.
        Returns the wrapped step's 5 output blocks (q, v, env, wrap, aux)
        as ``(rows, n)``. ``rounding`` is applied to every floating input
        and output (the control's lower precision)."""
        rnd = rounding or (lambda x: x)
        n = ins["q"].shape[1]
        k = self._block_items()
        outs = []
        for a in range(0, n, k):
            sl = slice(a, min(a + k, n))
            part = {name: rnd(x[:, sl].to(self.device, F64)) for name, x in ins.items()}
            draws = {name: rnd(x[sl].to(self.device, F64)) for name, x in noise.items()}
            got = self._step_block(part, draws, envs[sl])
            outs.append([rnd(o) for o in got])
        return tuple(torch.cat([o[i] for o in outs], 1) for i in range(5))

    def _step_block(self, ins, noise, envs):
        es, env = self.es, self.step_env
        n = ins["q"].shape[1]
        model = self._items_model(envs)
        nq, nv = env.model.nq, env.model.nv

        def field(name):
            r0, k = es.env_rows[name]
            return ins["env"][r0 : r0 + k].t()

        qpos, qvel = ins["q"].t(), ins["v"].t()
        first = ins["first"].t()
        first_q, first_v = first[:, :nq], first[:, nq : nq + nv]
        first_obs = first[:, nq + nv : nq + nv + es.hist]
        zeros = pipeline.zeros_state(model, first_q, first_v)
        info = {
            "action_buffer": field("action_buffer").reshape(n, 12, es.Da),
            "imu_buffer": field("imu_buffer").reshape(n, 6, es.Di),
            "command": field("command"),
            "desired_world_z_in_body_frame": field("desired_z"),
            "last_act": field("last_act"),
            "last_vel": field("last_vel"),
            "feet_air_time": field("feet_air_time"),
            "last_contact": field("last_contact") > 0.5,
            "step": field("step")[:, 0].round().to(torch.int32),
            "steps": ins["wrap"][0],
            "truncation": torch.zeros_like(ins["wrap"][0]),
            "first_qpos": first_q,
            "first_qvel": first_v,
            "first_obs": first_obs,
            "first_pipeline_state": zeros,
        }
        if es.priv:
            info["privileged_obs"] = info["first_privileged_obs"] = (
                first[:, nq + nv + es.hist : nq + nv + es.hist + es.npriv])
        state = State(qpos=qpos, qvel=qvel, obs=field("obs_history"),
                      reward=torch.zeros_like(ins["wrap"][0]), done=ins["wrap"][1],
                      metrics={}, info=info)
        wrapped = TrainingEnv(env, self.L, model, None)
        out = wrapped.step_from_draws(state, ins["act"].t(), noise)
        i = out.info
        rows = _rows64
        aux = {"reward": [out.reward], "done": [out.done], "truncation": [i["truncation"]],
               "rewards": [out.metrics[name] for name in soa_env.REWARD_ORDER],
               "total_dist": [out.metrics["total_dist"]]}
        if es.priv:
            aux["privileged"] = [i["privileged_obs"]]
        env_fields = {
            "action_buffer": i["action_buffer"], "imu_buffer": i["imu_buffer"],
            "command": i["command"], "desired_z": i["desired_world_z_in_body_frame"],
            "last_act": i["last_act"], "last_vel": i["last_vel"],
            "feet_air_time": i["feet_air_time"], "last_contact": i["last_contact"],
            "step": i["step"], "obs_history": out.obs[:, : es.hist],
        }
        return (rows([out.qpos]), rows([out.qvel]),
                rows([env_fields[name] for name in es.env_rows]),
                rows([i["steps"], out.done]),
                rows([x for name in self.aux_rows for x in aux[name]]))


def _rows64(parts: List[torch.Tensor]) -> torch.Tensor:
    """(n, ...) tensors -> one ``(rows, n)`` float64 block."""
    n = parts[0].shape[0]
    return torch.cat([x.to(F64).reshape(n, -1) for x in parts], 1).t()
