"""Driver ``train_step``: PPO training steps on the K3 lane, back to back.

One unit is one training step, call for call ``ppo.train``'s
``training_step`` (``puppax_torch/train/ppo.py``): the step's keys,
``num_unrolls`` x ``FastLane.unroll``, ``_cat_unrolls``, the normalizer's
``running_statistics.update``, ``gather_batch`` and
``num_updates_per_batch`` x ``sgd_pass``, with the config's learning-rate
and entropy schedules. Set-up builds the learner once and drives its first
``check_steps`` steps through the same call, recording the sampled envs'
env steps, the batches, each step's mean loss, Adam's first moment after
the first update and the weights before and after; the window goes on from
step ``check_steps + 1``. One step of the window, drawn from the seed among
``check_window_range`` (its ordinal in the window, from 1), records the
sampled envs' env steps too, on the device; the record is copied to the
host once the window has closed.

The check (after the window): the reference follows those steps; on the
window's step, where its weights are not the program's, it steps the envs
with the program's action. Its numbers: the share of recorded env steps outside tolerance
(``outside_pct``), the worst step's relative loss gap (``loss_gap``), and
by the worst leaf the gaps of the first gradient's norm (``grad_gap``) and
of the weights' change over the checked steps (``change_gap``).
"""

from __future__ import annotations

import copy
import math
import random as pyrandom
from typing import Dict, List, Optional

import torch

from portbench import program
from portbench.harness import Number

SPANS = ("pb.rollout", "pb.prepare", "pb.sgd")


class TrainStep:
    def __init__(self, ctx: program.Context):
        from puppax_torch import random
        from puppax_torch.parallel import mesh as mesh_lib
        from puppax_torch.train import ppo, running_statistics

        self.ctx, self.ppo, self.rs = ctx, ppo, running_statistics
        w = ctx.workload
        self.B = w["num_envs"]
        # "unchanged" here is the learner's fault (below), not the env step's
        self.recorder = program.Recorder("altered" if ctx.fault == "altered" else None)
        cfg, env, self.wrapped, self.lane, keys = program.build_env(ctx, self.B)
        self.cfg, t = cfg, cfg.train
        self.t = t
        self.T = t.unroll_length
        self.mesh = mesh_lib.make_env_mesh([ctx.device])
        self.nets = program.make_networks(cfg, env, keys["network"], ctx.device)
        self.params = (list(self.nets.policy_network.parameters())
                       + list(self.nets.value_network.parameters()))
        self.per_step = t.batch_size * t.unroll_length * t.num_minibatches
        after_init = max(t.num_evals - 1, 1)
        steps_per_epoch = max(1, math.ceil(t.num_timesteps / (after_init * self.per_step)))
        total = steps_per_epoch * after_init * t.num_updates_per_batch * t.num_minibatches
        self.optimizer = ppo.Adam(self.params, ppo.lr_schedule_fn(
            t.learning_rate, t.lr_schedule, t.lr_final_fraction, total))
        self.normalizer = running_statistics.init_state(env.observation_size, ctx.device)
        self.num_unrolls = t.batch_size * t.num_minibatches // self.B
        self.env_steps = 0
        self.state = self.wrapped.reset(keys["env"])
        self.cols_host = program.sample_cols(ctx.seed, self.B, w["check_envs"], 1)
        self.cols = self.cols_host.to(ctx.device)
        lo, hi = w["check_window_range"]
        self.window_check = pyrandom.Random(int(ctx.seed) * 7919 + 5).randrange(lo, hi)
        self.steps_done = 0  # training steps so far, the checked ones included
        self.window_units = 0
        self.record = {"start": program.start_blocks(self.lane, self.wrapped, self.state,
                                                      self.cols),
                       "unrolls": [], "batches": [], "losses": []}
        _, self.step_key = random.split(keys["key"]).unbind(0)  # the epoch's split
        self.marks: List[list] = []
        self.clock = None
        if ctx.fault == "unchanged":
            self.optimizer.step = lambda grads: None  # the step leaves the weights as they were
        first = self.optimizer.step

        def step_and_keep(grads):
            first(grads)
            if "first_mu" not in self.record:
                self.record["first_mu"] = [m.detach().cpu().clone() for m in self.optimizer.mu]

        self.optimizer.step = step_and_keep

    env_steps_per_unit = property(lambda self: self.per_step)

    def _mark(self, marks):
        if self.clock is not None:
            marks.append(self.clock.mark())

    def training_step(self, keep: Optional[str] = None) -> None:
        """One training step; ``keep`` records it: ``"warm"`` whole (a
        checked step of set-up), ``"window"`` its env steps."""
        ppo, t = self.ppo, self.t
        marks: list = []
        self._mark(marks)
        self.step_key, key_sgd, key_unroll = ppo.training_step_keys(self.step_key)
        data = []
        with torch.profiler.record_function("pb.rollout"):
            for u, k in enumerate(ppo.unroll_keys(key_unroll, self.num_unrolls)):
                self.recorder.on, self.recorder.cols = keep, self.cols
                self.state, d = self.lane.unroll(self.state, (self.normalizer,
                                                              self.nets.policy_network), k, self.T)
                self.recorder.on = False
                if keep:
                    self.record["unrolls"].append({
                        "ordinal": len(self.record["unrolls"]),
                        "train_step": len(self.record["batches"]) if keep == "warm" else None,
                        "steps_before": (self.steps_done * self.num_unrolls + u) * self.T,
                        "cols": self.cols_host, "launches": self.recorder.take(),
                        "trans": program.transition_slices(d, self.cols)})
                data.append(d)
        self._mark(marks)
        with torch.profiler.record_function("pb.prepare"):
            data = ppo._cat_unrolls(data)
            self.normalizer = self.rs.update(self.normalizer, data.observation, mesh=self.mesh)
            data = ppo.gather_batch(data, self.mesh, self.num_unrolls)
        self._mark(marks)
        if t.entropy_schedule == "linear":
            p = min(max(self.env_steps / float(t.num_timesteps), 0.0), 1.0)
            ec = t.entropy_cost + (t.entropy_cost_final - t.entropy_cost) * p
        else:
            ec = t.entropy_cost
        batch_size, sgd_data = t.batch_size, data
        if self.ctx.fault == "half_batch":  # half the batch left out, the mean over the rest
            half = data.reward.shape[1] // 2
            batch_size = t.batch_size // 2
            sgd_data = ppo._map_data(lambda x: x[:, :half], data)
        sums: Dict[str, torch.Tensor] = {}
        with torch.profiler.record_function("pb.sgd"):
            for _ in range(t.num_updates_per_batch):
                key_sgd = ppo.sgd_pass(
                    self.nets, self.optimizer, (self.normalizer, None), sgd_data, key_sgd, ec,
                    mesh=self.mesh, batch_size=batch_size, num_minibatches=t.num_minibatches,
                    lazy_shuffle=t.lazy_shuffle, sums=sums, discounting=t.discounting,
                    gae_lambda=t.gae_lambda, clipping_epsilon=t.clipping_epsilon,
                    reward_scaling=t.reward_scaling, normalize_advantage=True,
                    privileged_critic=False)
        self._mark(marks)
        if marks:
            self.marks.append(marks)
        self.env_steps += self.per_step
        self.steps_done += 1
        if keep == "warm":
            n = t.num_updates_per_batch * t.num_minibatches
            self.record["losses"].append(float(sums["total_loss"]) / n)
            self.record["batches"].append({
                "observation": data.observation.cpu(), "next_observation": data.next_observation.cpu(),
                "reward": data.reward.cpu(), "discount": data.discount.cpu(),
                "truncation": data.truncation.cpu(),
                "raw_action": data.policy_extras["raw_action"].cpu(),
                "log_prob": data.policy_extras["log_prob"].cpu()})

    # ---- the harness's calls ------------------------------------------------
    def warm(self) -> None:
        self.record["weights_before"] = [p.detach().cpu().clone() for p in self.params]
        for _ in range(self.ctx.workload["check_steps"]):
            self.training_step(keep="warm")
        self.record["weights_after"] = [p.detach().cpu().clone() for p in self.params]

    def unit(self, i: int) -> None:
        self.window_units += 1
        self.training_step(keep="window" if self.window_units == self.window_check else None)

    def check_units(self) -> int:
        """The window's units that the check needs to have run."""
        return self.window_check

    def span_ms(self) -> Dict[str, float]:
        """Per training step of the window: its rollout, prepare and SGD ms
        (CUDA events around the harness's calls)."""
        out = {name: 0.0 for name in SPANS}
        for m in self.marks:
            for name, a, b in zip(SPANS, m[:-1], m[1:]):
                out[name] += self.clock.ms(a, b) / len(self.marks)
        self.marks = []
        return out

    def release(self) -> None:
        self.recorder.remove()
        for name in ("state", "lane", "wrapped", "nets", "optimizer", "normalizer", "params"):
            setattr(self, name, None)

    def check(self, control: Optional[str] = None):
        import compare
        import judge
        import learner
        import refcell

        w, rec = self.ctx.workload, program.to_host(self.record)
        dev = self.ctx.device
        ref = refcell.Reference(self.ctx.config, self.B, self.ctx.seed, self.cols_host, device=dev)
        items = compare.Items()
        compare.start_items(items, rec["start"], ref.start_blocks())
        lrn = learner.Learner(ref, ref.cfg, self.B)
        # the TF32 control: the same learner with TF32 stands in the program's place
        lrn_c = None
        if control == "tf32":
            ref_c = refcell.Reference(self.ctx.config, self.B, self.ctx.seed, self.cols_host,
                                      device=dev)
            lrn_c = learner.Learner(ref_c, ref_c.cfg, self.B)
        losses, losses_c, plans = [], [], {}
        for k, batch in enumerate(rec["batches"]):
            key_sgd, ukeys = lrn.unroll_keys_next()
            # the reference's policy as it stands before its step k
            pol = {"normalizer": ref.normalizer, "policy": copy.deepcopy(ref.nets.policy_network)}
            for u in (u for u in rec["unrolls"] if u["train_step"] == k):
                plans[u["ordinal"]] = (pol, ref.eps(ukeys[u["ordinal"] % self.num_unrolls], self.T))
            losses.append(lrn.step(batch, key_sgd))
            if lrn_c is not None:
                key_c, _ = lrn_c.unroll_keys_next()
                with judge.tf32(True):
                    losses_c.append(lrn_c.step(batch, key_c))
        window = [u for u in rec["unrolls"] if u["train_step"] is None]
        judge.judge_unrolls(ref, items, rec["unrolls"],
                            lambda u: plans[u["ordinal"]][0] if u["ordinal"] in plans else None,
                            lambda u: plans[u["ordinal"]][1] if u["ordinal"] in plans else None,
                            control=control)
        want_change = [a.detach() - b for a, b in zip(lrn.params, lrn.start)]
        if lrn_c is not None:
            got_losses, got_grad = losses_c, lrn_c.first_grad
            got_change = [a.detach() - b for a, b in zip(lrn_c.params, lrn_c.start)]
        elif control is not None:  # a control of the env step alone: the learner's own
            got_losses, got_grad, got_change = losses, lrn.first_grad, want_change
        else:
            got_losses = rec["losses"]
            got_grad = [m / (1 - 0.9) for m in rec["first_mu"]]
            got_change = [a - b for a, b in zip(rec["weights_after"], rec["weights_before"])]
        loss_gap = max(abs(g - r) / max(abs(r), 1e-12) for g, r in zip(got_losses, losses))
        grad_gap, grad_leaf, left_out = learner.leaf_gap(
            [g.cpu() for g in got_grad], [g.cpu() for g in lrn.first_grad], lrn.names)
        change_gap, change_leaf, _ = learner.leaf_gap(
            [g.cpu() for g in got_change], [g.cpu() for g in want_change], lrn.names,
            floor_ref=[g.cpu() for g in lrn.first_grad])
        lim = w["limits"]
        # the window's checked step has to have run
        outside = items.share_pct() if window else 100.0
        numbers = [Number("outside_pct", outside, lim["outside_pct"]),
                   Number("loss_gap", loss_gap, lim["loss_gap"]),
                   Number("grad_gap", grad_gap, lim["grad_gap"]),
                   Number("change_gap", change_gap, lim["change_gap"])]
        notes = items.notes[:20] + [
            f"items {items.count}, outside {items.n_outside}, widest gap {items.widest():.4g} tolerances",
            f"losses program {got_losses} reference {losses}",
            f"grad gap at {grad_leaf}, change gap at {change_leaf}, left out {left_out}"]
        if not window:
            notes.append(f"the window's step {self.window_check} never ran")
        return numbers, notes


def make(ctx: program.Context) -> TrainStep:
    return TrainStep(ctx)
