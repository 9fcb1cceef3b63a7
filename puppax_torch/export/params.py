"""Policy export: a trained policy -> the JSON dict of the on-robot
controller.

Counterpart of ``puppax/export/params.py`` (``fold_in_normalization`` :25,
``convert_params`` :37, ``apply_exported_policy`` :109), the deployment
ABI: the robot's C++ runtime (``native/policy_runtime.cc``) replays the
dict, so

* the running normalizer's mean and std are folded into the first dense
  layer ((x - mean) / std followed by x K + b becomes one affine layer:
  K' = K / std[:, None], b' = b - K.T (mean / std)), and
* the last layer keeps only the loc half of the (loc, scale) Gaussian
  head, squashed by the final activation (tanh) on the robot.

``params`` is ``(normalizer, policy)``: the normalizer is the port's
``RunningStatisticsState`` or a checkpoint's ``{"mean", "std", ...}``
dict; the policy is the port's ``MLP`` or its state dict (``hidden_i.weight``
``(out, in)``, ``hidden_i.bias``), its layers taken in index order.

The JSON must equal the JAX package's on the same weights, number for
number. So each weight is rebuilt as the JAX package holds it, a
C-contiguous float32 ``(in, out)`` kernel (``nn.Linear``'s ``(out, in)``
transposed and copied: the transposed view alone is F-contiguous, and
numpy may send ``kernel.T @ v`` on another layout to another BLAS path
with another summation order), and then the JAX package's numpy code runs
line for line. This fold is not K4's (``env/fused_unroll.py::fold_normalizer``
computes ``b - (W / std) @ mean`` in float32 torch, as
``puppax/env/fused_unroll.py:63`` does): the reference keeps two folds that
round differently, and so does the port.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

_WEIGHT = re.compile(r"^hidden_(\d+)\.weight$")


def fold_in_normalization(kernel, bias, mean, std):
    """Fold (x - mean) / std into a dense layer's kernel/bias
    (reference export.py:7-10 semantics)."""
    kernel = np.asarray(kernel)
    bias = np.asarray(bias)
    mean = np.asarray(mean)
    std = np.asarray(std)
    folded_kernel = kernel / std[:, None]
    folded_bias = bias - kernel.T @ (mean / std)
    return folded_kernel, folded_bias


def _float32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def normalizer_arrays(normalizer) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) of a ``RunningStatisticsState`` or a checkpoint's
    normalizer dict, as float32 numpy arrays."""
    if isinstance(normalizer, dict):
        return _float32(normalizer["mean"]), _float32(normalizer["std"])
    return _float32(normalizer.mean), _float32(normalizer.std)


def policy_layers(policy) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(kernel, bias)] of an ``MLP`` or its state dict in layer order:
    each kernel a C-contiguous float32 ``(in, out)`` array, as the JAX
    package's flax tree holds it."""
    sd = policy.state_dict() if isinstance(policy, torch.nn.Module) else policy
    indices = sorted(int(m.group(1)) for m in map(_WEIGHT.match, sd) if m)
    if indices != list(range(len(indices))) or not indices:
        raise ValueError(f"policy layers {indices}: expected hidden_0 ... hidden_n")
    return [(np.ascontiguousarray(_float32(sd[f"hidden_{i}.weight"]).T),
             _float32(sd[f"hidden_{i}.bias"])) for i in indices]


def convert_params(
    params,
    activation: str,
    action_scale: float,
    kp: float,
    kd: float,
    default_pose,
    joint_upper_limits,
    joint_lower_limits,
    use_imu: bool,
    observation_history: int,
    maximum_pitch_command: float,
    maximum_roll_command: float,
    final_activation: str = "tanh",
    gait_phase_observation: bool = False,
    gait_frequency: float = 0.0,
    control_dt: float = 0.02,
) -> Dict:
    """Convert PPO params to the on-robot JSON policy dict (the ABI of
    reference export.py:13-81: same keys, same layer schema).

    Policies trained with the gait clock (env.gait_phase_observation)
    additionally carry ``gait_phase_observation`` / ``gait_frequency`` /
    ``control_dt`` so the on-robot controller knows to append the
    free-running (cos, sin) clock after the obs history — the native
    runtime (native/policy_runtime.cc) honors these keys."""
    normalizer, policy = params[0], params[1]
    mean, std = normalizer_arrays(normalizer)

    layer_items = policy_layers(policy)
    layers = []
    input_size = None
    for i, (kernel, bias) in enumerate(layer_items):
        if i == 0:
            kernel, bias = fold_in_normalization(kernel, bias, mean, std)
            input_size = kernel.shape[0]
        if i == len(layer_items) - 1:
            # keep only the mean head of the (loc, scale) Gaussian output
            half = bias.shape[-1] // 2
            kernel, bias = kernel[:, :half], bias[:half]
        layers.append(
            {
                "type": "dense",
                "activation": activation if i < len(layer_items) - 1 else final_activation,
                "shape": [None, int(bias.shape[-1])],
                "weights": [kernel.tolist(), bias.tolist()],
            }
        )

    return {
        "use_imu": use_imu,
        "control_orientation": True,
        "observation_history": observation_history,
        "action_scale": action_scale,
        "kp": kp,
        "kd": kd,
        "default_joint_pos": np.asarray(default_pose).tolist(),
        "joint_upper_limits": np.asarray(joint_upper_limits).tolist(),
        "joint_lower_limits": np.asarray(joint_lower_limits).tolist(),
        "maximum_pitch_command": maximum_pitch_command,
        "maximum_roll_command": maximum_roll_command,
        "gait_phase_observation": bool(gait_phase_observation),
        "gait_frequency": float(gait_frequency),
        "control_dt": float(control_dt),
        "in_shape": [None, int(input_size)],
        "layers": layers,
    }


def apply_exported_policy(exported: Dict, observation) -> np.ndarray:
    """Replay an exported JSON policy on an observation (the on-robot C++
    controller's forward pass, reimplemented for round-trip testing)."""
    activations = {
        "relu": lambda x: np.maximum(x, 0.0),
        # minimum clips the expm1 argument so np.where's eagerly-evaluated
        # negative branch cannot overflow for large positive inputs
        "elu": lambda x: np.where(x > 0, x, np.expm1(np.minimum(x, 0.0))),
        "tanh": np.tanh,
        "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
        "swish": lambda x: x / (1.0 + np.exp(-x)),
        "silu": lambda x: x / (1.0 + np.exp(-x)),
        "linear": lambda x: x,
    }
    x = np.asarray(observation, np.float64)
    for layer in exported["layers"]:
        kernel, bias = layer["weights"]
        x = x @ np.asarray(kernel) + np.asarray(bias)
        x = activations[layer["activation"]](x)
    return x
