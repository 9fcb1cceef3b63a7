"""The plain PPO learner the training cell is judged by: a frozen copy of
the port's ``train/ppo.py`` arithmetic (commit 1ec45da): truncation-aware
GAE, the clipped surrogate with the 0.25 value factor and the one-sample
entropy bonus, the running normalizer, optax's Adam without the clip, the
learning-rate and entropy schedules and the learner's key tree. It runs on
the batches the program collected (the program's rollout, which the
check's env-step items judge apart) with its own weights.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from refport import random
from refport.train import running_statistics


def training_step_keys(key):
    key, key_sgd, key_unroll = random.split(key, 3).unbind(0)
    return key, key_sgd, key_unroll


def unroll_keys(key, n: int) -> List[torch.Tensor]:
    out = []
    for _ in range(n):
        key, k = random.split(key).unbind(0)
        out.append(k)
    return out


def sgd_update_keys(key, num_minibatches: int, total_batch: int):
    key, key_perm, key_grad = random.split(key, 3).unbind(0)
    perm = random.permutation(key_perm, total_batch)
    loss_keys = []
    for _ in range(num_minibatches):
        key_grad, key_loss = random.split(key_grad).unbind(0)
        loss_keys.append(key_loss)
    return key, perm, loss_keys


def gae(truncation, termination, rewards, values, bootstrap, lambda_, discount):
    mask = 1.0 - truncation
    v_next = torch.cat([values[1:], bootstrap[None]], 0)
    deltas = (rewards + discount * (1.0 - termination) * v_next - values) * mask
    acc = torch.zeros_like(bootstrap)
    out = [None] * deltas.shape[0]
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + discount * (1.0 - termination[t]) * mask[t] * lambda_ * acc
        out[t] = acc
    vs = torch.stack(out) + values
    vs_next = torch.cat([vs[1:], bootstrap[None]], 0)
    adv = (rewards + discount * (1.0 - termination) * vs_next - values) * mask
    return vs.detach(), adv.detach()


def ppo_loss(nets, norm, mb: Dict[str, torch.Tensor], eps, entropy_cost: float, t) -> torch.Tensor:
    n = float(mb["reward"].numel())
    dist = nets.action_distribution

    def normed(x):
        return (x - norm.mean) / norm.std

    logits = nets.policy_network(normed(mb["observation"]))
    baseline = nets.value_network(normed(mb["observation"])).squeeze(-1)
    boot = nets.value_network(normed(mb["next_observation"][-1])).squeeze(-1)
    rewards = mb["reward"] * t.reward_scaling
    trunc = mb["truncation"]
    term = (1.0 - mb["discount"]) * (1.0 - trunc)
    target_lp = dist.log_prob(logits, mb["raw_action"])
    vs, adv = gae(trunc, term, rewards, baseline, boot, t.gae_lambda, t.discounting)
    mean = torch.sum(adv) / n
    dev = adv - mean
    adv = dev / (torch.sqrt(torch.sum(dev * dev) / n) + 1e-8)
    rho = torch.exp(target_lp - mb["log_prob"])
    eps_c = t.clipping_epsilon
    policy_loss = -torch.sum(torch.minimum(rho * adv, torch.clamp(rho, 1 - eps_c, 1 + eps_c) * adv)) / n
    value_loss = 0.25 * (torch.sum((vs - baseline) ** 2) / n)
    entropy = torch.sum(dist.entropy(logits, eps=eps)) / n
    return policy_loss + value_loss - entropy_cost * entropy


def lr_fn(t, total_updates: int) -> Callable[[int], float]:
    lr, frac = t.learning_rate, t.lr_final_fraction
    if t.lr_schedule == "constant":
        return lambda c: lr
    if t.lr_schedule == "cosine":
        return lambda c: lr * ((1 - frac) * 0.5 * (1 + math.cos(math.pi * min(c, total_updates)
                                                                 / total_updates)) + frac)
    end = lr * frac
    return lambda c: (lr - end) * (1 - min(max(c, 0), total_updates) / total_updates) + end


class Adam:
    """optax's adam (b1 0.9, b2 0.999, eps 1e-8), the bias corrections in
    float32 at the incremented count, the lr at the count before it."""

    def __init__(self, params: List[torch.Tensor], lr: Callable[[int], float]):
        self.params, self.lr, self.count = params, lr, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        c = self.count + 1
        bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(c))
        lr = self.lr(self.count)
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            m.mul_(0.9).add_(g, alpha=1 - 0.9)
            v.mul_(0.999).add_(g * g, alpha=1 - 0.999)
            p.add_((m / bc1) / (torch.sqrt(v / bc2) + 1e-8), alpha=-lr)
        self.count = c


class Learner:
    """The reference's learner state: weights, normalizer, Adam and the key
    chain, stepped on the program's batches."""

    def __init__(self, ref, cfg, num_envs: int):
        t = cfg.train
        self.t, self.ref = t, ref
        self.nets = ref.nets
        self.params = (list(self.nets.policy_network.parameters())
                       + list(self.nets.value_network.parameters()))
        self.names = ([f"policy.{n}" for n, _ in self.nets.policy_network.named_parameters()]
                      + [f"value.{n}" for n, _ in self.nets.value_network.named_parameters()])
        self.per_step = t.batch_size * t.unroll_length * t.num_minibatches
        after_init = max(t.num_evals - 1, 1)
        steps_per_epoch = max(1, math.ceil(t.num_timesteps / (after_init * self.per_step)))
        total = steps_per_epoch * after_init * t.num_updates_per_batch * t.num_minibatches
        self.adam = Adam(self.params, lr_fn(t, total))
        self.env_steps = 0
        self.num_unrolls = t.batch_size * t.num_minibatches // num_envs
        self.first_grad = None
        self.start = [p.detach().clone() for p in self.params]
        key, step_key = random.split(ref.keys["key"].to(ref.device)).unbind(0)
        self.step_key = step_key

    def unroll_keys_next(self) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """This training step's (sgd key, unroll keys), advancing the chain."""
        self.step_key, key_sgd, key_unroll = training_step_keys(self.step_key)
        return key_sgd, unroll_keys(key_unroll, self.num_unrolls)

    def step(self, batch: Dict[str, torch.Tensor], key_sgd) -> float:
        """The normalizer update and ``num_updates_per_batch`` SGD passes on
        a ``(T, num_envs * unrolls)`` batch; returns the mean loss."""
        t, dev = self.t, self.ref.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        self.ref.normalizer = running_statistics.update(self.ref.normalizer, batch["observation"])
        if t.entropy_schedule == "linear":
            p = min(max(self.env_steps / float(t.num_timesteps), 0.0), 1.0)
            ec = t.entropy_cost + (t.entropy_cost_final - t.entropy_cost) * p
        else:
            ec = t.entropy_cost
        T = batch["reward"].shape[0]
        mbs, act = t.num_minibatches, self.nets.action_distribution.event_size
        losses = []
        for _ in range(t.num_updates_per_batch):
            key_sgd, perm, loss_keys = sgd_update_keys(key_sgd, mbs, t.batch_size * mbs)
            shuffled = {k: v.index_select(1, perm).reshape((T, mbs, -1) + v.shape[2:]).transpose(0, 1)
                        for k, v in batch.items()}
            for m, kl in enumerate(loss_keys):
                mb = {k: v[m] for k, v in shuffled.items()}
                eps = random.normal(kl, (T, t.batch_size, act))
                loss = ppo_loss(self.nets, self.ref.normalizer, mb, eps, ec, t)
                grads = torch.autograd.grad(loss, self.params)
                if self.first_grad is None:
                    self.first_grad = [g.detach().clone() for g in grads]
                self.adam.step(grads)
                losses.append(loss.detach())
        self.env_steps += self.per_step
        return float(torch.stack(losses).mean())


def leaf_gap(got: List[torch.Tensor], want: List[torch.Tensor], names: List[str],
             floor_ref: List[torch.Tensor] = None) -> Tuple[float, str, List[str]]:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and the median leaf's. Leaves whose
    reference gradient (``floor_ref``, default ``want``) is under a
    thousandth of the median leaf's are left out. Returns (gap, its leaf,
    the leaves left out)."""
    floor_ref = want if floor_ref is None else floor_ref
    fl = [float(x.norm()) for x in floor_ref]
    med_f = float(np.median(fl))
    wn = [float(x.norm()) for x in want]
    med = float(np.median(wn))
    worst, where, out = 0.0, "", []
    for g, w, f, name in zip(got, wn, fl, names):
        if f < 1e-3 * med_f:
            out.append(name)
            continue
        gap = abs(float(g.norm()) - w) / max(w, med, 1e-30)
        if not math.isfinite(gap):
            gap = float("inf")
        if gap >= worst:
            worst, where = gap, name
    return worst, where, out
