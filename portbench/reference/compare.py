"""How far the program's env steps lie from the reference's.

An item is one env at one checked step (or at the start): it is outside
when any of its numbers leaves its tolerance. The tolerances are those
``chip_smoke.py`` holds team K3 to against its plain version
(``wrapped_tols``), with the rows the action reaches widened to 1e-5: here
the reference steps with its own action, which its own float32 policy
gives to ~1e-6. Integers (episode steps, done, truncation, contact flags,
the env's step count) and the keys are exact.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

OUTPUTS = ("q", "v", "env", "wrap", "aux")


def _scaled(want: torch.Tensor, tol: float) -> torch.Tensor:
    return tol * want.abs().amax(0, keepdim=True).clamp_min(1.0).expand_as(want)


def step_tolerances(es, aux_rows, want: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-row tolerances of the wrapped step's 5 outputs (q, v, env, wrap,
    aux) against the reference's ``want``."""
    tols = {
        "q": torch.full_like(want[0], 5e-5),
        "v": _scaled(want[1], 5e-4),
        "env": torch.full_like(want[2], 1e-4),
        "wrap": torch.zeros_like(want[3]),
        "aux": torch.full_like(want[4], 2e-4),
    }
    env = tols["env"]
    for name, tol in (("obs_history", 2e-4), ("action_buffer", 1e-5), ("command", 1e-6),
                      ("desired_z", 1e-6), ("last_act", 1e-5), ("feet_air_time", 1e-5),
                      ("last_contact", 0.0), ("step", 0.0)):
        r0, n = es.env_rows[name]
        env[r0 : r0 + n] = tol
    r0, n = es.env_rows["last_vel"]
    env[r0 : r0 + n] = _scaled(want[1], 5e-4)[:1].expand(n, -1)
    aux = tols["aux"]
    for name in ("done", "truncation"):
        aux[aux_rows[name][0]] = 0.0
    r0, n = aux_rows["rewards"]
    aux[r0 : r0 + n] = 2e-4 * want[4][r0 : r0 + n].abs().clamp_min(1.0)
    return tols


def outside(got: torch.Tensor, want: torch.Tensor, tol) -> torch.Tensor:
    """``(n,)`` bool: the columns where any row leaves ``tol`` (a NaN is
    outside)."""
    got, want = got.float().cpu(), want.float().cpu()
    tol = tol.cpu() if isinstance(tol, torch.Tensor) else torch.full_like(want, float(tol))
    err = (got - want).abs()
    return ((err > tol) | ~torch.isfinite(got)).any(0)


def gap(got: torch.Tensor, want: torch.Tensor, tol) -> torch.Tensor:
    """``(n,)`` the widest error of a column in units of its tolerance (an
    exact row counts as tolerance 1e-30)."""
    got, want = got.float().cpu(), want.float().cpu()
    tol = tol.cpu() if isinstance(tol, torch.Tensor) else torch.full_like(want, float(tol))
    err = torch.nan_to_num((got - want).abs(), nan=float("inf"))
    return (err / tol.clamp_min(1e-30)).amax(0)


class Items:
    """The checked items of a run: how many, which are outside, and the
    widest gap in tolerances."""

    def __init__(self):
        self.flags: List[torch.Tensor] = []
        self.gaps: List[torch.Tensor] = []
        self.notes: List[str] = []

    def add(self, what: str, pairs: List[tuple]) -> None:
        """``pairs`` of (got, want, tol) over the same ``n`` columns: one
        item per column."""
        flag = torch.zeros(pairs[0][0].shape[-1], dtype=torch.bool)
        g = torch.zeros(flag.shape)
        for got, want, tol in pairs:
            got2 = got.reshape(-1, got.shape[-1])
            want2 = want.reshape(-1, want.shape[-1])
            tol2 = tol.reshape(-1, tol.shape[-1]) if isinstance(tol, torch.Tensor) else tol
            flag |= outside(got2, want2, tol2)
            g = torch.maximum(g, gap(got2, want2, tol2))
        self.flags.append(flag)
        self.gaps.append(g)
        if bool(flag.any()):
            self.notes.append(f"{what}: {int(flag.sum())} of {flag.numel()} outside")

    @property
    def count(self) -> int:
        return sum(int(f.numel()) for f in self.flags)

    @property
    def n_outside(self) -> int:
        return sum(int(f.sum()) for f in self.flags)

    def share_pct(self) -> float:
        return 100.0 * self.n_outside / max(self.count, 1)

    def widest(self) -> float:
        return max((float(g.max()) for g in self.gaps if g.numel()), default=0.0)


def start_items(items: Items, got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
    """The program's reset state against the reference's, env by env."""
    items.add("start", [
        (got["q"], want["q"], 5e-5),
        (got["v"], want["v"], 5e-4),
        (got["env"], want["env"], 2e-4),
        (got["wrap"], want["wrap"], 0.0),
        (got["first"], want["first"], 2e-4),
        (got["dr"], want["dr"], 1e-6 * want["dr"].abs().clamp_min(1.0)),
        (got["rng"].t(), want["rng"].t(), 0.0),
    ])


def step_items(items: Items, ref, got_out: Sequence[torch.Tensor],
               want_out: Sequence[torch.Tensor], extra: List[tuple], what: str) -> None:
    """The program's wrapped-step outputs (and ``extra`` pairs, such as the
    transition's fields) against the reference's, env step by env step."""
    tols = step_tolerances(ref.es, ref.aux_rows, [w.cpu() for w in want_out])
    pairs = [(g, w, tols[name]) for name, g, w in zip(OUTPUTS, got_out, want_out)]
    items.add(what, pairs + extra)
