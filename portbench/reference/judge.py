"""The check of the env steps a run recorded: the reference steps every
recorded env from the program's state at that step with its own action,
draws and DR'd model, and each (step, env) is an item, in or outside
tolerance (``compare.py``).

Two controls put the reference in the program's place, computed in the
nearest precision below what the configuration states: ``tf32`` the
policy's products with TF32 (its float32 dots run with TF32 off), and
``bf16`` the env step (float32 in the kernels) with its inputs and outputs
rounded through bfloat16. Their outputs are judged against the reference's
on the same states.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

from compare import Items, step_items
from refcell import bf16

CONTROLS = ("tf32", "bf16")


@contextlib.contextmanager
def tf32(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _actions(ref, u: Dict, policy: Optional[Dict], eps_all, tf32_on: bool):
    """Each recorded step's action rows and the policy's outputs: the
    reference's from ``policy`` and the unroll's draws, or where ``policy``
    is None the program's action and no policy outputs."""
    out = []
    r0, n = ref.es.env_rows["obs_history"]
    eps = None if policy is None else eps_all[:, u["cols"].to(eps_all.device)]  # (T, n, act)
    with tf32(tf32_on):
        for t, (ins, _) in enumerate(u["launches"]):
            if policy is None:
                out.append((ins[2], None))
                continue
            act, raw, logp = ref.policy_rows(ins[3][r0 : r0 + n], eps[t].t(), **policy)
            out.append((act, (act.cpu(), raw.cpu(), logp.cpu())))
    return out


def _step_all(ref, unrolls: List[Dict], actions: List[List], noises: List[List],
              rounding=None) -> List[tuple]:
    """The reference step on every recorded (step, env) at once, split back
    into one 5-tuple of output blocks per recorded step."""
    ins, noise, envs, widths = {k: [] for k in ("q", "v", "act", "env", "first", "wrap")}, [], [], []
    for u, acts, nz in zip(unrolls, actions, noises):
        n = len(u["cols"])
        for t, (blocks, _) in enumerate(u["launches"]):
            for k, b in zip(("q", "v", "env", "first", "wrap"), (0, 1, 3, 6, 7)):
                ins[k].append(blocks[b])
            ins["act"].append(acts[t][0].cpu())
            noise.append(nz[t])
            envs.append(torch.arange(n))
            widths.append(n)
    cat = {k: torch.cat(v, 1) for k, v in ins.items()}
    draws = {k: torch.cat([d[k].cpu() for d in noise], 0) for k in noise[0]}
    outs = ref.step(cat, draws, torch.cat(envs), rounding=rounding)
    pieces = [o.cpu().split(widths, 1) for o in outs]
    return [tuple(p[j] for p in pieces) for j in range(len(widths))]


def judge_unrolls(ref, items: Items, unrolls: List[Dict],
                  policy_of: Callable[[Dict], Optional[Dict]],
                  eps_of: Callable[[Dict], Optional[torch.Tensor]],
                  control: Optional[str] = None) -> None:
    """Add every recorded (step, env) of ``unrolls`` to ``items``.
    ``policy_of(u)`` gives the reference's normalizer and policy for unroll
    ``u`` (None: the program's action stands), ``eps_of(u)`` its sampling
    draws ``(T, B, act)``; ``control`` one of ``CONTROLS``."""
    if not unrolls:
        return
    noises = [ref.noise(ref.rng_after(u["steps_before"]), len(u["launches"])) for u in unrolls]
    want_act, got_act = [], []
    for u in unrolls:
        policy, eps = policy_of(u), eps_of(u)
        want_act.append(_actions(ref, u, policy, eps, False))
        got_act.append(_actions(ref, u, policy, eps, True) if control == "tf32" else None)
    want_all = _step_all(ref, unrolls, want_act, noises)
    got_all = None
    if control == "tf32":
        got_all = _step_all(ref, unrolls, got_act, noises)
    elif control == "bf16":
        got_all, got_act = _step_all(ref, unrolls, want_act, noises, rounding=bf16), want_act
    aux = ref.aux_rows
    r0, n = ref.es.env_rows["obs_history"]
    k = 0
    for ui, u in enumerate(unrolls):
        tr = u["trans"]
        for t, (ins, outs) in enumerate(u["launches"]):
            want = want_all[k]
            pol_w = want_act[ui][t][1]
            if control is not None:
                got = got_all[k]
                pol_g = got_act[ui][t][1]
                reward_g, done_g = got[4][aux["reward"][0]], got[4][aux["done"][0]]
                trunc_g = got[4][aux["truncation"][0]]
            else:
                got = outs
                pol_g = None if pol_w is None else (ins[2], tr["raw"][t].t(), tr["logp"][t])
                reward_g, done_g, trunc_g = tr["reward"][t], 1.0 - tr["discount"][t], tr["truncation"][t]
            extra = [
                (reward_g[None], want[4][aux["reward"][0]][None],
                 2e-4 * want[4][aux["reward"][0]][None].abs().clamp_min(1.0)),
                (done_g[None], want[4][aux["done"][0]][None], 0.0),
                (trunc_g[None], want[4][aux["truncation"][0]][None], 0.0),
            ]
            if pol_w is not None:
                extra += [(pol_g[0], pol_w[0], 1e-5), (pol_g[1], pol_w[1], 1e-5),
                          (pol_g[2][None], pol_w[2][None], 2e-4)]
            if control is None:
                # the transition's next observation is the step's output rows
                extra.append((tr["next_obs"][t].t(), want[2][r0 : r0 + n], 2e-4))
            step_items(items, ref, got, want, extra, f"unroll {u['ordinal']} step {t}")
            k += 1
