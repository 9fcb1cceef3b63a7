"""The batched Pupper v3 env, its wrappers and the rollout fast lane."""

from puppax_torch.env.pupper import PupperV3Env

__all__ = ["PupperV3Env"]
