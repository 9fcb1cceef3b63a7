"""The harness's side of the port: build the system under test from a
configuration and a seed, and record what its timed path produces at the
env steps the check samples.

Everything the window runs is the port's own code (``puppax_torch``):
``PupperV3Env``, ``wrap_for_training``, ``FastLane.unroll`` and the
learner's functions. ``Recorder`` wraps the fast lane's call of the
wrapped env step (``soa_env.wrapped_step``, team K3) so that, while it is
on, the inputs and outputs of the sampled envs are kept; it adds nothing
while it is off. Faults for the correctness tests are planted here too,
where the answer is produced.
"""

from __future__ import annotations

import functools
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

FAULTS = ("unchanged", "altered", "half_batch")


@dataclass
class Context:
    """What a driver is given: the cell's files, the seed, the device, and
    a fault to plant (tests and readings only)."""

    config: Dict[str, Any]
    workload: Dict[str, Any]
    seed: int
    device: torch.device
    fault: Optional[str] = None


def build_env(ctx: Context, num_envs: int):
    """The port's env, its DR'd training wrapper, the fast lane and the key
    tree of ``ctx.seed``, as ``ppo.train`` makes them."""
    from puppax_torch.configs import experiment as exp
    from puppax_torch.configs import get_config
    from puppax_torch.env import rollout
    from puppax_torch.env.domain_randomization import domain_randomize
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.train import ppo

    cfg = exp.from_dict(ctx.config["experiment"])
    env = PupperV3Env.from_config(cfg.env, reward_config=get_config(), device=ctx.device)
    dr = cfg.domain_randomization
    keys = ppo.init_keys(ctx.seed, num_envs, dr.enabled, ctx.device)
    fn = None
    if dr.enabled:
        ranges = {k: v for k, v in exp.to_dict(dr).items() if k != "enabled"}
        fn = functools.partial(domain_randomize, **ranges)
    wrapped = wrap_for_training(env, cfg.train.episode_length, randomization_fn=fn,
                                randomization_keys=keys.get("dr"))
    ok, reason = rollout.support_reason(wrapped)
    if not ok:
        raise SystemExit(f"the fast lane does not take this cell: {reason}")
    print(f"portbench: rollout fast lane ON ({reason}) at {num_envs} envs", file=sys.stderr)
    return cfg, env, wrapped, rollout.FastLane(wrapped), keys


def make_networks(cfg, env, key, device):
    from puppax_torch.train import networks

    t = cfg.train
    return networks.make_ppo_networks(
        env.observation_size, env.action_size, t.policy_hidden_layer_sizes,
        t.value_hidden_layer_sizes, t.activation, device=device, key=key,
        value_precision=t.value_precision)


def start_blocks(lane, wrapped, state, cols: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reset state's carry blocks, DR rows and keys of envs ``cols``."""
    carry = lane.carry_from_state(state)
    out = {k: carry[k][:, cols].cpu() for k in ("q", "v", "env", "wrap", "first")}
    out["dr"] = wrapped.dr_rows(state.qpos.shape[0])[:, cols].cpu()
    out["rng"] = state.info["rng"][cols].cpu()
    return out


class Recorder:
    """Wraps ``soa_env.wrapped_step`` for the fast lane. While ``on`` it
    keeps each launch's 8 input and 5 output blocks at the envs ``cols``,
    on the device (``to_host`` copies them once the window has closed);
    ``fault`` plants ``unchanged`` (the step returns its input state) or
    ``altered`` (every env's reward raised by 0.01) into every launch."""

    def __init__(self, fault: Optional[str] = None):
        from puppax_torch.env import soa_env

        self.module = soa_env
        self.original = soa_env.wrapped_step
        self.fault = fault
        self.on = False
        self.cols: Optional[torch.Tensor] = None
        self.steps: List[tuple] = []
        # the step counts its launches on whatever the module's name holds
        self.launches = 0
        self.__name__ = self.original.__name__
        soa_env.wrapped_step = self

    def __call__(self, s, es, n_substeps, episode_length, *blocks):
        outs = self.original(s, es, n_substeps, episode_length, *blocks)
        if self.fault == "unchanged":
            outs = (blocks[0], blocks[1], blocks[3], blocks[7], outs[4])
        elif self.fault == "altered":
            r0, _ = self.module.aux_row_map(es)["reward"]
            aux = outs[4].clone()
            aux[r0] += 0.01
            outs = (*outs[:4], aux)
        if self.on:
            c = self.cols
            self.steps.append(([b.index_select(1, c) for b in blocks],
                               [o.index_select(1, c) for o in outs]))
        return outs

    def take(self) -> List[tuple]:
        """The kept launches; clears them."""
        out, self.steps = self.steps, []
        return out

    def remove(self) -> None:
        self.module.wrapped_step = self.original


def transition_slices(data, cols: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A time-major transition's fields the check reads, at envs ``cols``
    (on the device)."""
    return {
        "reward": data.reward[:, cols],
        "discount": data.discount[:, cols],
        "truncation": data.truncation[:, cols],
        "next_obs": data.next_observation[:, cols],
        "raw": data.policy_extras["raw_action"][:, cols],
        "logp": data.policy_extras["log_prob"][:, cols],
    }


def to_host(x):
    """``x`` (tensors in dicts, lists and tuples) with every tensor on the
    host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def sample_cols(seed: int, n: int, k: int, salt: int) -> torch.Tensor:
    """``k`` distinct envs of ``n``, drawn from the seed."""
    g = torch.Generator().manual_seed((int(seed) * 1000003 + salt) % (2**63))
    return torch.randperm(n, generator=g)[:k].sort().values
