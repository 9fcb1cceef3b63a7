"""Driver ``rollout``: ``FastLane.unroll`` back to back, as collection.

One unit is one T-step unroll of ``num_envs`` envs on the K3 lane with DR
on, the policy's weights random from the seed (``ppo.init_keys``' network
key through the networks' factory) and the normalizer at its start. Each
unroll's key comes from the learner's key chain (``split`` per unroll),
its env noise from the envs' own key chains, as ``ppo.train`` draws them.
Set-up resets the envs and runs ``warmup_unrolls`` unrolls through the same
call. ``check_unrolls`` unrolls of the window, drawn from the seed among
``check_unroll_range``, record ``check_envs`` envs of every step on the
device; the record is copied to the host once the window has closed.

The check (after the window): the reference steps each recorded env from
the program's state at that step, and judges the reset state apart. Its
number: the share of recorded env steps outside tolerance (``outside_pct``).
"""

from __future__ import annotations

import random as pyrandom
from typing import Dict, List, Optional

import torch

from portbench import program
from portbench.harness import Number


class Rollout:
    def __init__(self, ctx: program.Context):
        from puppax_torch import random
        from puppax_torch.train import running_statistics

        self.ctx, self.random = ctx, random
        w = ctx.workload
        self.B, self.T = w["num_envs"], w["unroll_length"]
        self.recorder = program.Recorder(ctx.fault)
        cfg, env, self.wrapped, self.lane, keys = program.build_env(ctx, self.B)
        nets = program.make_networks(cfg, env, keys["network"], ctx.device)
        self.params = (running_statistics.init_state(env.observation_size, ctx.device),
                       nets.policy_network)
        self.state = self.wrapped.reset(keys["env"])
        self.key = keys["key"]
        self.cols_host = program.sample_cols(ctx.seed, self.B, w["check_envs"], 2)
        self.cols = self.cols_host.to(ctx.device)
        lo, hi = w["check_unroll_range"]
        picks = pyrandom.Random(int(ctx.seed) * 7919 + 3).sample(range(lo, hi), w["check_unrolls"])
        self.checked = {w["warmup_unrolls"] + i for i in picks}  # ordinals in the whole run
        self.record = {"start": program.start_blocks(self.lane, self.wrapped, self.state,
                                                      self.cols), "unrolls": []}
        self.ordinal = 0
        self.clock = None

    env_steps_per_unit = property(lambda self: self.B * self.T)

    def unroll(self, record: bool = False) -> None:
        self.key, k = self.random.split(self.key).unbind(0)
        keep = self.ordinal in self.checked
        self.recorder.on, self.recorder.cols = keep or record, self.cols
        with torch.profiler.record_function("pb.unroll"):
            self.state, data = self.lane.unroll(self.state, self.params, k, self.T)
        self.recorder.on = False
        if keep:
            self.record["unrolls"].append({
                "ordinal": self.ordinal, "steps_before": self.ordinal * self.T,
                "cols": self.cols_host, "launches": self.recorder.take(),
                "trans": program.transition_slices(data, self.cols)})
        self.ordinal += 1

    # ---- the harness's calls ------------------------------------------------
    def warm(self) -> None:
        for i in range(self.ctx.workload["warmup_unrolls"]):
            # the first records its envs too, so that recording in the
            # window runs nothing for the first time
            self.unroll(record=i == 0)
            self.recorder.take()

    def unit(self, i: int) -> None:
        self.unroll()

    def span_ms(self) -> Dict[str, float]:
        return {}

    def check_units(self) -> int:
        """The window's units that the check needs to have run."""
        return max(self.checked) - self.ctx.workload["warmup_unrolls"] + 1

    def release(self) -> None:
        self.recorder.remove()
        self.state = self.lane = self.wrapped = self.params = None

    def check(self, control: Optional[str] = None):
        import compare
        import judge
        import refcell

        w, rec = self.ctx.workload, program.to_host(self.record)
        missing = sorted(self.checked - {u["ordinal"] for u in rec["unrolls"]})
        ref = refcell.Reference(self.ctx.config, self.B, self.ctx.seed, self.cols_host,
                                device=self.ctx.device)
        items = compare.Items()
        compare.start_items(items, rec["start"], ref.start_blocks())
        keys: List[torch.Tensor] = []
        key = ref.keys["key"]
        for _ in range(max(self.checked) + 1):
            key, k = refcell.split2(key)
            keys.append(k)
        judge.judge_unrolls(ref, items, rec["unrolls"], lambda u: {},
                            lambda u: ref.eps(keys[u["ordinal"]], self.T), control=control)
        numbers = [Number("outside_pct", items.share_pct() if not missing else 100.0,
                          w["limits"]["outside_pct"])]
        notes = items.notes[:20] + [
            f"items {items.count}, outside {items.n_outside}, widest gap "
            f"{items.widest():.4g} tolerances"]
        if missing:
            notes.append(f"checked unrolls {missing} never ran in the window")
        return numbers, notes


def make(ctx: program.Context) -> Rollout:
    return Rollout(ctx)
