"""The PPO learner: one process per device, a rank of a process group
across several.

Counterpart of ``puppax/train/ppo.py``: the same algorithm (clipped
surrogate, truncation-aware GAE, running observation normalization,
single-sample entropy bonus, 0.25 value-loss factor), hyperparameters,
callbacks (``progress_fn(step, metrics)``, ``policy_params_fn(step,
make_policy, params)``) and ``<checkpoint_dir>/state/<step>/`` train-state
checkpoints. What differs:

* Eager PyTorch: each training step is a Python loop of
  ``num_unrolls_per_env`` unrolls, the time-major reorder, the normalizer
  update and ``num_updates_per_batch`` x ``num_minibatches`` SGD steps.
  The unrolls take the rollout fast lane (``FastLane.unroll``: the
  wrapped-step kernel K3, or with ``PUPPAX_FUSED_UNROLL=on`` the fused
  unroll K4) when ``rollout.support_reason`` allows it, else the standard
  lane (``acting.generate_unroll``: the env-step kernel K2, or under
  ``PUPPAX_SOA_ENV=off`` the physics-only lane on the physics-step kernel
  K1); the ``[puppax.ppo] rollout fast lane`` line says which and why. The
  evaluator steps the standard lane.
* Several devices: one process per GPU under ``torch.distributed.run``
  (``puppax_torch/parallel/mesh.py``), not one process over a mesh. Each
  rank steps its share of the envs and of the evaluation's; every rank
  draws the whole key tree and keeps its rows, the sampling eps of the
  world's envs included; the normalizer reduces its batch moments across
  the ranks (``running_statistics.update(mesh=)``); the ranks all-gather
  the training batch (``gather_batch``), each computes its part of every
  minibatch's loss over its share of the minibatch's rows, and the
  gradients are all-reduced before ``Adam.step`` (``all_reduce_grads``),
  so the clip sees the global norm and a sharded run computes what one
  process computes. Only rank 0 prints the lane line and writes.
* Randomness: the JAX learner's key tree on jax's threefry
  (``puppax_torch.random``): ``init_keys`` (``ppo.py:204-211, 621``), one
  split per epoch, ``training_step_keys`` (``:504``), ``unroll_keys``
  (``:480``) and ``sgd_update_keys`` (``:391, 411-414``), and the
  networks' initial weights through flax's key path
  (``networks.flax_param_key``, ``:591-594``), so every key, draw and
  initial weight is the JAX run's for the same seed.
* The env-step count is a Python int: the JAX package's ``StepCount`` keeps
  two int32 limbs only because JAX runs without x64. A JAX train state
  converts (``convert_orbax_checkpoint.py``) and resumes.
* ``Adam`` reproduces ``optax.chain(clip_by_global_norm, adam)``: the lr
  schedule is read at the update count before the increment, and the clip
  has no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
* The loss's means are sums over the minibatch's entry count (a rank's
  share of them sums to its part).
* Each training step records its rollout, reorder + normalizer and SGD
  phases (CUDA events on the card, the host clock on the CPU); their means
  per epoch join the metrics as ``training/{rollout,prepare,sgd}_ms``.

The privileged critic (``privileged_critic``: the value net also sees the
env's ``privileged_obs``, through a normalizer of its own over both), the
disturbance curriculum (``curriculum_steps``: the env's difficulty set to
``curriculum_difficulty`` before each training step's rollout) and
``action_repeat`` are the JAX package's.
"""

from __future__ import annotations

import math as pymath
import os
import time
from dataclasses import dataclass, fields, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from puppax_torch import random
from puppax_torch.env import rollout, wrappers
from puppax_torch.parallel import mesh as mesh_lib
from puppax_torch.train import acting, checkpoint, running_statistics
from puppax_torch.train import networks as ppo_networks
from puppax_torch.train.acting import Transition

# the base of the JAX package's two-limb env-step count (ppo.py StepCount)
_STEP_BASE = 2**30


def init_keys(seed: int, num_envs: int, randomize: bool, device) -> Dict[str, torch.Tensor]:
    """The start of the key tree (``puppax/train/ppo.py:204-211, 621``):
    ``key`` (the epochs' chain), ``network``, ``eval``, ``env`` (the
    ``(num_envs, 2)`` reset keys) and, with DR, ``dr`` (its ``(num_envs,
    2)`` keys)."""
    key, network_key, env_key, eval_key = random.split(random.key(seed, device), 4).unbind(0)
    out = {"network": network_key, "eval": eval_key}
    if randomize:
        key, key_dr = random.split(key).unbind(0)
        out["dr"] = random.split(key_dr, num_envs)
    out["key"] = key
    out["env"] = random.split(env_key, num_envs)
    return out


def training_step_keys(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the next step's key, the SGD's key, the rollout's key) of one
    training step (``ppo.py:504``)."""
    key, key_sgd, key_unroll = random.split(key, 3).unbind(0)
    return key, key_sgd, key_unroll


def unroll_keys(key: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The keys of a training step's ``n`` unrolls (``ppo.py:480``: per
    unroll ``k, k_unroll = split(k)``)."""
    out = []
    for _ in range(n):
        key, k_unroll = random.split(key).unbind(0)
        out.append(k_unroll)
    return out


def sgd_update_keys(key: torch.Tensor, num_minibatches: int, total_batch: int):
    """One pass of SGD over the batch (``ppo.py:391, 411-414``): returns
    (the next pass's key, the permutation of the ``total_batch`` rows, the
    minibatches' loss keys)."""
    key, key_perm, key_grad = random.split(key, 3).unbind(0)
    perm = random.permutation(key_perm, total_batch)
    loss_keys = []
    for _ in range(num_minibatches):
        key_grad, key_loss = random.split(key_grad).unbind(0)
        loss_keys.append(key_loss)
    return key, perm, loss_keys


def compute_gae(truncation, termination, rewards, values, bootstrap_value,
                lambda_: float, discount: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncation-aware GAE over (T, B) data (``ppo.py:92-129``).
    ``termination`` ends the bootstrap; ``truncation`` masks the TD error.
    Returns (value targets, advantages), both detached."""
    truncation_mask = 1.0 - truncation
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], 0)
    deltas = rewards + discount * (1.0 - termination) * values_t_plus_1 - values
    deltas = deltas * truncation_mask
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [None] * deltas.shape[0]
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + discount * (1.0 - termination[t]) * truncation_mask[t] * lambda_ * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], 0)
    advantages = (rewards + discount * (1.0 - termination) * vs_t_plus_1 - values) * truncation_mask
    return vs.detach(), advantages.detach()


def curriculum_difficulty(env_steps: int, curriculum_steps: int) -> np.float32:
    """The disturbance curriculum's difficulty after ``env_steps`` env steps,
    ``clip(steps / curriculum_steps, 0, 1)`` in float32 from the count split
    as ``hi * 2**30 + lo``, as the JAX package computes it (``ppo.py:506-520``)."""
    hi, lo = divmod(int(env_steps), _STEP_BASE)
    f32 = np.float32
    steps_f = f32(hi) * f32(_STEP_BASE) + f32(lo)
    return f32(min(max(steps_f / f32(curriculum_steps), f32(0.0)), f32(1.0)))


def critic_inputs(data: Transition) -> Tuple[torch.Tensor, torch.Tensor]:
    """The privileged critic's inputs of a time-major batch: the
    observations beside their privileged obs, and the bootstrap's (the last
    next observation beside its privileged obs)."""
    return (torch.cat([data.observation, data.extras["privileged_obs"]], -1),
            torch.cat([data.next_observation[-1], data.extras["next_privileged_obs"][-1]], -1))


def compute_ppo_loss(networks, normalizer, data: Transition, entropy_eps: torch.Tensor,
                     entropy_cost: float, *, discounting: float = 0.97,
                     gae_lambda: float = 0.95, clipping_epsilon: float = 0.3,
                     reward_scaling: float = 1.0, normalize_advantage: bool = True,
                     privileged_critic: bool = False, critic_normalizer=None,
                     total: Optional[int] = None, mesh=None,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The PPO loss of a time-major (T, mb) minibatch (``ppo.py:306-384``);
    ``entropy_eps`` are the normal draws of the entropy estimate and
    ``normalizer`` is None when observations are not normalized. The
    privileged critic's value net reads ``critic_inputs`` through
    ``critic_normalizer`` (None when observations are not normalized).

    ``data`` may be a rank's share of a minibatch of ``total`` (t, row)
    entries (default: ``data``'s own): each mean is then the share's sum
    over ``total``, the rank's part of the loss, and the advantages'
    mean and standard deviation are reduced over ``mesh``'s ranks
    (``parallel.EnvMesh``), so the ranks' parts sum to the minibatch's
    loss. One process computes the same sums over its whole minibatch."""
    n = float(data.reward.numel() if total is None else total)
    dist = networks.action_distribution
    policy_logits = networks.policy_apply(normalizer, data.observation)
    if privileged_critic:
        critic_obs, critic_boot = critic_inputs(data)
        value_norm = critic_normalizer
    else:
        critic_obs, critic_boot = data.observation, data.next_observation[-1]
        value_norm = normalizer
    baseline = networks.value_apply(value_norm, critic_obs)
    bootstrap_value = networks.value_apply(value_norm, critic_boot)

    rewards = data.reward * reward_scaling
    truncation = data.truncation
    termination = (1.0 - data.discount) * (1.0 - truncation)
    target_lp = dist.log_prob(policy_logits, data.policy_extras["raw_action"])
    behaviour_lp = data.policy_extras["log_prob"]

    vs, advantages = compute_gae(truncation, termination, rewards, baseline, bootstrap_value,
                                 gae_lambda, discounting)
    if normalize_advantage:
        # jnp.std: the population standard deviation, two passes
        mean = mesh_lib.all_reduce_(torch.sum(advantages), mesh, "advantages") / n
        dev = advantages - mean
        var = mesh_lib.all_reduce_(torch.sum(dev * dev), mesh, "advantages") / n
        advantages = dev / (torch.sqrt(var) + 1e-8)

    rho = torch.exp(target_lp - behaviour_lp)
    surrogate = rho * advantages
    clipped = torch.clamp(rho, 1.0 - clipping_epsilon, 1.0 + clipping_epsilon) * advantages
    policy_loss = -torch.sum(torch.minimum(surrogate, clipped)) / n

    v_error = vs - baseline
    value_loss = 0.25 * (torch.sum(v_error * v_error) / n)

    entropy = torch.sum(dist.entropy(policy_logits, eps=entropy_eps)) / n
    entropy_loss = -entropy_cost * entropy

    total = policy_loss + value_loss + entropy_loss
    return total, {
        "total_loss": total,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy_loss": entropy_loss,
    }


def lr_schedule_fn(learning_rate: float, lr_schedule: str, lr_final_fraction: float,
                   total_updates: int) -> Callable[[int], float]:
    """The learning rate at an update count: optax's ``constant``,
    ``cosine_decay_schedule`` (alpha = ``lr_final_fraction``) or
    ``linear_schedule`` to ``learning_rate * lr_final_fraction``."""
    if lr_schedule == "constant":
        return lambda count: learning_rate
    if lr_schedule == "cosine":
        if total_updates <= 0:
            raise ValueError("the cosine schedule needs total_updates > 0")

        def cosine(count):
            c = min(count, total_updates)
            decay = 0.5 * (1.0 + pymath.cos(pymath.pi * c / total_updates))
            return learning_rate * ((1.0 - lr_final_fraction) * decay + lr_final_fraction)

        return cosine
    if lr_schedule == "linear":
        end = learning_rate * lr_final_fraction
        if total_updates <= 0:
            return lambda count: learning_rate

        def linear(count):
            frac = 1.0 - min(max(count, 0), total_updates) / total_updates
            return (learning_rate - end) * frac + end

        return linear
    raise ValueError(f"unknown lr_schedule {lr_schedule!r}")


class Adam:
    """``optax.chain(optax.clip_by_global_norm(max_grad_norm),
    optax.adam(lr))`` over a list of parameters, updated in place: b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, bias correction at the
    incremented count, ``lr(count)`` at the count before it."""

    def __init__(self, params: List[torch.Tensor], lr: Callable[[int], float],
                 max_grad_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = list(grads)
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads), alpha=1 - b2)
        count_inc = self.count + 1
        # 1 - decay**count in float32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count_inc))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_add_(self.params, updates, alpha=-self.lr(self.count))
        self.count = count_inc

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, tree: Dict) -> None:
        self.count = int(tree["count"])
        for dst, src in zip(self.mu + self.nu, list(tree["mu"]) + list(tree["nu"])):
            dst.copy_(src)


@dataclass
class TrainingState:
    networks: ppo_networks.PPONetworks
    optimizer: Adam
    normalizer_params: running_statistics.RunningStatisticsState
    env_steps: int = 0
    # the privileged critic's running statistics over [obs, privileged obs]
    # (None without the privileged critic)
    critic_normalizer_params: Optional[running_statistics.RunningStatisticsState] = None

    def state_dict(self) -> Dict:
        """The checkpoint tree: parameters, optimizer, normalizer, env steps,
        and the critic normalizer where there is one."""
        tree = {
            "params": params_state_dict((self.normalizer_params, self.networks.params)),
            "optimizer": self.optimizer.state_dict(),
            "env_steps": int(self.env_steps),
        }
        if self.critic_normalizer_params is not None:
            tree["critic_normalizer"] = _normalizer_tree(self.critic_normalizer_params)
        return tree

    def load_state_dict(self, tree: Dict) -> None:
        p = tree["params"]
        self.networks.policy_network.load_state_dict(p["policy"])
        self.networks.value_network.load_state_dict(p["value"])
        self.normalizer_params = _normalizer_from_tree(p["normalizer"], self.normalizer_params)
        if (self.critic_normalizer_params is None) != ("critic_normalizer" not in tree):
            raise ValueError("the checkpoint and the run differ on the privileged critic")
        if self.critic_normalizer_params is not None:
            self.critic_normalizer_params = _normalizer_from_tree(
                tree["critic_normalizer"], self.critic_normalizer_params)
        self.optimizer.load_state_dict(tree["optimizer"])
        self.env_steps = int(tree["env_steps"])


def _normalizer_tree(normalizer) -> Dict:
    return {f.name: getattr(normalizer, f.name) for f in fields(normalizer)}


def _normalizer_from_tree(tree: Dict, like) -> running_statistics.RunningStatisticsState:
    dev = like.mean.device
    return running_statistics.RunningStatisticsState(**{k: v.to(dev) for k, v in tree.items()})


def params_state_dict(params) -> Dict:
    """``(normalizer, PPONetworkParams)`` as a checkpoint tree."""
    normalizer, nets = params
    return {
        "normalizer": _normalizer_tree(normalizer),
        "policy": nets.policy.state_dict(),
        "value": nets.value.state_dict(),
    }


# the transition fields the learner reads, besides policy_extras and extras
_LEARNER_FIELDS = ("observation", "action", "reward", "discount", "next_observation",
                   "truncation")


def _map_data(fn, data: Transition) -> Transition:
    """``fn`` on every tensor of the transition fields the learner reads."""
    return replace(
        data,
        **{f: fn(getattr(data, f)) for f in _LEARNER_FIELDS},
        policy_extras={k: fn(v) for k, v in data.policy_extras.items()},
        extras={k: fn(v) for k, v in data.extras.items()},
    )


def minibatches(data: Transition, perm: torch.Tensor, num_minibatches: int,
                lazy_shuffle: bool):
    """The minibatches of one SGD pass over a (T, N) batch in the order of
    ``perm``: the eager shuffle gathers the whole batch once and splits it
    (``ppo.py:399-407``), ``lazy_shuffle`` gathers each minibatch on its own
    (``ppo.py:416-447``); both give the same minibatches."""
    if lazy_shuffle:
        for idx in perm.reshape(num_minibatches, -1):
            yield _map_data(lambda x: x.index_select(1, idx), data)
        return
    shuffled = _map_data(
        lambda x: x.index_select(1, perm).reshape(
            (x.shape[0], num_minibatches, -1) + x.shape[2:]).transpose(0, 1),
        data,
    )
    for m in range(num_minibatches):
        yield _map_data(lambda x: x[m], shuffled)


class _PhaseTimer:
    """Per-phase times of the training steps of one epoch: CUDA events on
    the card (read after the epoch's closing synchronize), else the host
    clock."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks: List[list] = []

    def mark(self, step_marks: list) -> None:
        if self._cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            step_marks.append(e)
        else:
            step_marks.append(time.perf_counter())

    def new_step(self) -> list:
        self._marks.append([])
        self.mark(self._marks[-1])
        return self._marks[-1]

    def mean_ms(self, names) -> Dict[str, float]:
        sums = [0.0] * len(names)
        for m in self._marks:
            for i in range(len(names)):
                a, b = m[i], m[i + 1]
                sums[i] += a.elapsed_time(b) if self._cuda else (b - a) * 1000.0
        n = max(len(self._marks), 1)
        self._marks = []
        return {name: s / n for name, s in zip(names, sums)}


def train(
    environment,
    num_timesteps: int,
    episode_length: int,
    num_envs: int = 4096,
    num_eval_envs: int = 128,
    action_repeat: int = 1,
    learning_rate: float = 3e-4,
    lr_schedule: str = "constant",
    lr_final_fraction: float = 0.0,
    entropy_cost: float = 1e-2,
    entropy_schedule: str = "constant",
    entropy_cost_final: float = 0.0,
    discounting: float = 0.97,
    unroll_length: int = 20,
    batch_size: int = 256,
    num_minibatches: int = 32,
    num_updates_per_batch: int = 4,
    reward_scaling: float = 1.0,
    clipping_epsilon: float = 0.3,
    gae_lambda: float = 0.95,
    normalize_advantage: bool = True,
    normalize_observations: bool = True,
    lazy_shuffle: bool = False,
    max_grad_norm: Optional[float] = None,
    seed: int = 0,
    num_evals: int = 1,
    deterministic_eval: bool = False,
    network_factory: Callable = ppo_networks.make_ppo_networks,
    privileged_critic: bool = False,
    curriculum_steps: int = 0,
    randomization_fn: Optional[Callable] = None,
    progress_fn: Callable[[int, Dict], None] = lambda *args: None,
    policy_params_fn: Callable[..., None] = lambda *args: None,
    eval_env=None,
    device=None,
    devices=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    metrics_logger=None,
):
    """Train a PPO policy; returns (make_policy, params, metrics) with
    ``params = (normalizer_state, PPONetworkParams)``.

    ``environment`` is a ``PupperV3Env`` on ``device`` (default ``cuda:0``;
    without a card the caller must pass ``"cpu"``), ``randomization_fn(model,
    keys) -> model`` batches the DR leaves over the envs' ``(num_envs, 2)``
    keys, and ``network_factory(obs_size, action_size, device=, key=)``
    builds the networks. ``checkpoint_dir`` saves the full train state at every
    eval epoch under ``<checkpoint_dir>/state/<env_steps>/``; ``resume``
    restarts from the latest one (the envs are reset anew).

    In a process group (``parallel.maybe_initialize_distributed``: one
    process per GPU under ``torch.distributed.run``) each call is one rank
    of the run: it steps its share of the ``num_envs`` (and
    ``num_eval_envs``) envs, every rank draws the whole key tree, the
    normalizer's moments, the minibatches' advantages, the gradients and
    the metrics are reduced over the ranks, and only rank 0 prints the
    lane line and writes the checkpoints; the result is the
    single-process run's. ``devices`` names this process's one device: a
    list of several raises (``parallel.make_env_mesh``)."""
    mesh = mesh_lib.make_env_mesh([device] if devices is None else devices)
    device = mesh.device
    if privileged_critic and not getattr(environment, "_privileged_obs", False):
        raise ValueError("privileged_critic=True requires the env to publish "
                         "info['privileged_obs'] (PupperV3Env(privileged_obs=True))")
    if entropy_schedule not in ("constant", "linear"):
        raise ValueError(f"unknown entropy_schedule {entropy_schedule!r}")
    if torch.device(environment.device) != device:
        raise ValueError(f"the environment is on {environment.device}, training on {device}")

    env_step_per_training_step = batch_size * unroll_length * num_minibatches * action_repeat
    num_evals_after_init = max(num_evals - 1, 1)
    num_training_steps_per_epoch = max(
        1, pymath.ceil(num_timesteps / (num_evals_after_init * env_step_per_training_step))
    )
    if (batch_size * num_minibatches) % num_envs != 0:
        raise ValueError(f"batch_size * num_minibatches = {batch_size * num_minibatches} "
                         f"is not a multiple of num_envs = {num_envs}")
    num_unrolls_per_env = (batch_size * num_minibatches) // num_envs
    for name, n in (("num_envs", num_envs), ("num_eval_envs", num_eval_envs),
                    ("batch_size", batch_size)):
        if n % mesh.world:
            raise ValueError(f"{name} = {n} does not split over {mesh.world} ranks")
    rows = mesh_lib.env_sharding(mesh, num_envs)  # this rank's envs

    # the whole key tree on every rank; each rank keeps its envs' keys
    keys = init_keys(seed, num_envs, randomization_fn is not None, device)
    env = wrappers.wrap_for_training(
        environment, episode_length=episode_length, action_repeat=action_repeat,
        randomization_fn=randomization_fn,
        randomization_keys=keys["dr"][rows] if "dr" in keys else None,
    )
    lane_ok, lane_reason = rollout.support_reason(env)
    lane = rollout.FastLane(env, mesh=mesh) if lane_ok else None
    if mesh.is_lead:
        ranks = (f", rank {mesh.rank} of {mesh.world}, backend {mesh.backend}"
                 if mesh.backend else "")
        fused = f", fused-unroll={'ON' if lane.use_fused(unroll_length) else 'OFF'}" if lane else ""
        print(f"[puppax.ppo] rollout fast lane: {'ON' if lane_ok else 'OFF'} ({lane_reason}; "
              f"devices={mesh.world}{ranks}{fused})", flush=True)
    obs_size, action_size = environment.observation_size, environment.action_size

    priv_size = environment.privileged_obs_size if privileged_critic else 0
    networks = network_factory(obs_size, action_size, device=device, key=keys["network"],
                               **({"privileged_size": priv_size} if privileged_critic else {}))
    make_policy = ppo_networks.make_inference_fn(networks)
    params = list(networks.policy_network.parameters()) + list(networks.value_network.parameters())
    total_updates = (num_training_steps_per_epoch * num_evals_after_init
                     * num_updates_per_batch * num_minibatches)
    optimizer = Adam(params, lr_schedule_fn(learning_rate, lr_schedule, lr_final_fraction,
                                            total_updates), max_grad_norm)
    ts = TrainingState(networks, optimizer, running_statistics.init_state(obs_size, device),
                       critic_normalizer_params=running_statistics.init_state(
                           obs_size + priv_size, device) if privileged_critic else None)
    state_dir = None if checkpoint_dir is None else os.path.join(str(checkpoint_dir), "state")
    if resume and state_dir is not None:
        step = checkpoint.latest_checkpoint_step(state_dir)
        if step is not None:
            ts.load_state_dict(checkpoint.restore_checkpoint(state_dir, step, device))

    # the standard lane restores the reset-time pipeline state on done
    env_state = env.reset(keys["env"][rows], caches=lane is None)
    if curriculum_steps > 0 and "difficulty" not in env_state.info:
        raise ValueError("curriculum_steps > 0 requires an environment with "
                         "disturbance_curriculum=True (info['difficulty'] missing)")

    eval_wrapped = wrappers.wrap_for_training(
        environment if eval_env is None else eval_env, episode_length=episode_length,
        action_repeat=action_repeat,
    )
    evaluator = acting.Evaluator(
        eval_wrapped,
        lambda p: (make_policy(p, deterministic=True) if deterministic_eval else
                   acting.shard_policy(make_policy(p), mesh, num_eval_envs, action_size)),
        num_eval_envs=num_eval_envs, episode_length=episode_length,
        action_repeat=action_repeat, key=keys["eval"], mesh=mesh,
    )

    def policy_params():
        return (ts.normalizer_params if normalize_observations else None,
                networks.policy_network)

    def sgd_step(data: Transition, ec_now: float, sums: Dict[str, torch.Tensor], key):
        norms = ((ts.normalizer_params, ts.critic_normalizer_params) if normalize_observations
                 else (None, None))
        return sgd_pass(networks, optimizer, norms, data, key, ec_now, mesh=mesh,
                        batch_size=batch_size, num_minibatches=num_minibatches,
                        lazy_shuffle=lazy_shuffle, sums=sums, discounting=discounting,
                        gae_lambda=gae_lambda, clipping_epsilon=clipping_epsilon,
                        reward_scaling=reward_scaling, normalize_advantage=normalize_advantage,
                        privileged_critic=privileged_critic)

    timer = _PhaseTimer(device)

    def training_step(env_state, sums, key):
        marks = timer.new_step()
        key, key_sgd, key_unroll = training_step_keys(key)
        if curriculum_steps > 0:
            # the disturbance curriculum ramps with the env steps, set before
            # each training step's rollout
            d = float(curriculum_difficulty(ts.env_steps, curriculum_steps))
            env_state = env_state.replace(info=dict(
                env_state.info, difficulty=torch.full_like(env_state.info["difficulty"], d)))
        data = []
        for k_unroll in unroll_keys(key_unroll, num_unrolls_per_env):
            if lane is not None:
                env_state, d = lane.unroll(env_state, policy_params(), k_unroll, unroll_length)
            else:
                with torch.no_grad():
                    policy = acting.shard_policy(make_policy(policy_params()), mesh, num_envs,
                                                 action_size)
                    env_state, d = acting.generate_unroll(env, env_state, policy, k_unroll,
                                                          unroll_length)
            data.append(d)
        timer.mark(marks)
        data = _cat_unrolls(data)
        if normalize_observations:
            ts.normalizer_params = running_statistics.update(ts.normalizer_params,
                                                             data.observation, mesh=mesh)
            if privileged_critic:
                ts.critic_normalizer_params = running_statistics.update(
                    ts.critic_normalizer_params, critic_inputs(data)[0], mesh=mesh)
        data = gather_batch(data, mesh, num_unrolls_per_env)
        timer.mark(marks)
        if entropy_schedule == "linear":
            progress = min(max(ts.env_steps / float(num_timesteps), 0.0), 1.0)
            ec_now = entropy_cost + (entropy_cost_final - entropy_cost) * progress
        else:
            ec_now = entropy_cost
        for _ in range(num_updates_per_batch):
            key_sgd = sgd_step(data, ec_now, sums, key_sgd)
        timer.mark(marks)
        ts.env_steps += env_step_per_training_step
        return env_state, key

    key = keys["key"]
    all_metrics: Dict[str, float] = {}
    if num_evals > 1:
        all_metrics = evaluator.run_evaluation(policy_params())
        progress_fn(0, all_metrics)

    for i in range(num_evals_after_init):
        if ts.env_steps >= num_timesteps:
            break  # resumed past the target
        key, step_key = random.split(key).unbind(0)  # ppo.py:747
        t = time.perf_counter()
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(num_training_steps_per_epoch):
            env_state, step_key = training_step(env_state, sums, step_key)
        n = num_training_steps_per_epoch * num_updates_per_batch * num_minibatches
        if mesh.backend is not None:  # the ranks' parts of each loss
            summed = mesh_lib.all_reduce_(torch.stack(list(sums.values())), mesh, "metrics")
            sums = dict(zip(sums, summed))
        train_metrics = {k: float(v) / n for k, v in sums.items()}  # synchronizes
        epoch_time = time.perf_counter() - t
        phases = timer.mean_ms(("rollout_ms", "prepare_ms", "sgd_ms"))
        metrics = {
            "training/sps": num_training_steps_per_epoch * env_step_per_training_step / epoch_time,
            "training/walltime": epoch_time,
            **{f"training/{k}": v for k, v in train_metrics.items()},
            **{f"training/{k}": v for k, v in phases.items()},
        }
        if num_evals > 1 or i == num_evals_after_init - 1:
            metrics.update(evaluator.run_evaluation(policy_params()))
        all_metrics = metrics
        progress_fn(ts.env_steps, metrics)
        policy_params_fn(ts.env_steps, make_policy, (ts.normalizer_params, networks.params))
        if state_dir is not None and mesh.is_lead:  # one writer
            path = checkpoint.save_checkpoint(ts.env_steps, ts.state_dict(), state_dir)
            if metrics_logger is not None:
                metrics_logger.log_artifact(path, name=f"checkpoint_state_{ts.env_steps}")

    return make_policy, (ts.normalizer_params, networks.params), all_metrics


def sgd_pass(networks, optimizer: Adam, normalizers, data: Transition, key: torch.Tensor,
             entropy_cost: float, *, mesh, batch_size: int, num_minibatches: int,
             lazy_shuffle: bool = False, sums: Optional[Dict[str, torch.Tensor]] = None,
             **loss_kw) -> torch.Tensor:
    """One pass of SGD over the world's time-major ``(T, num_minibatches *
    batch_size)`` batch (``ppo.py:409-458``); returns the next pass's key.
    ``normalizers`` is (the observation normalizer, the critic's), None
    each where observations are not normalized. Each minibatch is the same
    global rows on every rank; a rank (``mesh``) computes its part of the
    loss over its share of them (``mesh_lib.env_sharding(mesh,
    batch_size)``), the gradients are all-reduced before ``optimizer.step``,
    and the parts of each loss add into ``sums``."""
    norm, critic_norm = normalizers
    T = data.reward.shape[0]
    action_size = networks.action_distribution.event_size
    share = mesh_lib.env_sharding(mesh, batch_size)
    key, perm, loss_keys = sgd_update_keys(key, num_minibatches, batch_size * num_minibatches)
    perm = perm.reshape(num_minibatches, batch_size)[:, share].reshape(-1)
    for mb, key_loss in zip(minibatches(data, perm, num_minibatches, lazy_shuffle), loss_keys):
        # the entropy's draw, jax.random.normal(key_loss, loc.shape), of the
        # whole minibatch; the share's columns
        eps = random.normal(key_loss, (T, batch_size, action_size))
        loss, metrics = compute_ppo_loss(networks, norm, mb, eps[:, share], entropy_cost,
                                         critic_normalizer=critic_norm, total=T * batch_size,
                                         mesh=mesh, **loss_kw)
        optimizer.step(all_reduce_grads(torch.autograd.grad(loss, optimizer.params), mesh))
        if sums is not None:
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
    return key


def all_reduce_grads(grads, mesh) -> List[torch.Tensor]:
    """The ranks' gradients summed (each rank's is its part of the
    minibatch's mean), as one flat all-reduce; one process's as they are."""
    grads = list(grads)
    if mesh.backend is None:
        return grads
    flat = mesh_lib.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh, "grads")
    return [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]


def gather_batch(data: Transition, mesh, num_unrolls: int) -> Transition:
    """The world's ``(T, U * B)`` batch from every rank's ``(T, U * B_rank)``
    one, its columns in the single process's order (unroll, then rank,
    then env: the rank's envs are its slice of the world's): every field
    the learner reads packed into one float32 tensor for one all-gather.
    One process's batch as it is."""
    if mesh.backend is None:
        return data
    leaves = ([(f, getattr(data, f)) for f in _LEARNER_FIELDS]
              + [(("policy_extras", k), v) for k, v in data.policy_extras.items()]
              + [(("extras", k), v) for k, v in data.extras.items()])
    T, n = data.reward.shape[:2]
    widths = [int(np.prod(x.shape[2:], dtype=np.int64)) for _, x in leaves]
    for name, x in leaves:
        if x.dtype != torch.float32:
            raise TypeError(f"the transition's {name} is {x.dtype}, not float32")
    packed = torch.cat([x.reshape(T, n, w) for (_, x), w in zip(leaves, widths)], -1)
    got = mesh_lib.all_gather(packed, mesh, "batch")  # (world, T, U * B_rank, F)
    per = n // num_unrolls
    got = got.reshape(mesh.world, T, num_unrolls, per, -1).permute(1, 2, 0, 3, 4)
    got = got.reshape(T, num_unrolls * mesh.world * per, -1)
    out, c = {}, 0
    for (name, x), w in zip(leaves, widths):
        out[name] = got[..., c:c + w].reshape((T, got.shape[1]) + x.shape[2:])
        c += w
    return replace(
        data, **{f: out[f] for f in _LEARNER_FIELDS},
        policy_extras={k: out[("policy_extras", k)] for k in data.policy_extras},
        extras={k: out[("extras", k)] for k in data.extras},
        metrics={},
    )


def _cat_unrolls(data: List[Transition]) -> Transition:
    """U time-major (T, B_env) unrolls -> one (T, U * B_env) batch, unroll
    major (the JAX package's swapaxes + reshape)."""
    first = data[0]
    return replace(
        first,
        **{f: torch.cat([getattr(d, f) for d in data], dim=1) for f in _LEARNER_FIELDS},
        policy_extras={k: torch.cat([d.policy_extras[k] for d in data], dim=1)
                       for k in first.policy_extras},
        extras={k: torch.cat([d.extras[k] for d in data], dim=1) for k in first.extras},
    )
