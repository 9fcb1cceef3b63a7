"""puppax_torch: the PyTorch / CUDA port of puppax.

The rollout fast lane of PPO training on the flat Pupper v3 model: the
model tables, the batched joystick env with domain randomization, the
policy network, and the wrapped env-step kernel (CUDA C generated from the
same value algebra the JAX package lowers to Pallas). Importing this
package never imports jax, flax or mujoco.
"""

__version__ = "0.1.0"
