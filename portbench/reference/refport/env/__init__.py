"""The batched Pupper v3 env and its wrappers."""

from refport.env.pupper import PupperV3Env

__all__ = ["PupperV3Env"]
