"""puppax_torch: the PyTorch / CUDA port of puppax.

PPO training of the joystick policy on the flat Pupper v3 model: the model
tables, the batched env with domain randomization and its wrappers, the
rollout fast lane through the wrapped env-step kernel (K3), the evaluator's
standard lane through the unwrapped env-step kernel (K2), the learner,
checkpoints and the training CLI (``python -m puppax_torch.scripts.train``).
Both kernels are CUDA C generated from the same value algebra the JAX
package lowers to Pallas. Importing this package never imports jax, flax,
optax, orbax, mujoco or the JAX package.
"""

__version__ = "0.2.0"
