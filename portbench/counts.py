"""The yardstick's arithmetic: a kernel's share of its roofline and a
step's share of the chip's FP32 peak, from the operations and bytes frozen
in each configuration's file (``frozen_counts``), never from what the
program reports of itself.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from portbench.harness import PEAK_FP32_FLOPS, PEAK_HBM_BYTES


def kernel_device_s(trace: Dict[str, Any], trace_name: str) -> float:
    """Device seconds of the traced tail's activities whose name holds
    ``trace_name``."""
    return sum(us for name, us in trace["device_us"].items() if trace_name in name) / 1e6


def roofline_pct(counts: Dict[str, Any], kernel: str, trace: Dict[str, Any],
                 env_steps: int) -> Optional[float]:
    """``kernel``'s share of its roofline in the tail, in %: the least time
    the chip could take for its frozen operations and bytes over
    ``env_steps`` env steps (the larger of operations over the FP32 peak
    and bytes over HBM bandwidth) divided by its device time. None where
    the tail ran no such kernel."""
    k = counts["kernels"][kernel]
    secs = kernel_device_s(trace, k["trace_name"])
    if secs <= 0.0 or env_steps <= 0:
        return None
    least = max(k["float_ops_per_env_step"] * env_steps / PEAK_FP32_FLOPS,
                k["bytes_per_env_step"] * env_steps / PEAK_HBM_BYTES)
    return 100.0 * least / secs


def rollout_flops(counts: Dict[str, Any], env_steps: int) -> float:
    """Env steps through team K3, each with one policy forward pass."""
    return env_steps * (counts["kernels"]["k3"]["float_ops_per_env_step"]
                        + counts["networks"]["policy_flops_per_sample"])


def sgd_flops(counts: Dict[str, Any], train: Dict[str, Any]) -> float:
    """One training step's SGD: every minibatch's forward and backward (3
    forward passes' worth) of the policy and the value on its T x batch
    rows, and of the value on its batch bootstrap rows."""
    n = counts["networks"]
    mbs = train["num_updates_per_batch"] * train["num_minibatches"]
    rows = train["unroll_length"] * train["batch_size"]
    return mbs * 3.0 * (rows * (n["policy_flops_per_sample"] + n["value_flops_per_sample"])
                        + train["batch_size"] * n["value_flops_per_sample"])


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0.0:
        return None
    return 100.0 * flops / (seconds * PEAK_FP32_FLOPS)
