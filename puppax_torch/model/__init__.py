"""Robot model: tables carried across from the MJCF compile."""

from puppax_torch.model.mjcf import CompiledModel, RobotModel, load_model

__all__ = ["CompiledModel", "RobotModel", "load_model"]
