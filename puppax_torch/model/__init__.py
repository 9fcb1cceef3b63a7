"""Robot model: tables carried across from the MJCF compile, and the XML
surgery, obstacle and heightfield terrain applied before that compile (as
``puppax.model`` exports them)."""

from puppax_torch.model.mjcf import CompiledModel, RobotModel, load_model
from puppax_torch.model.obstacles import add_boxes_to_model
from puppax_torch.model.surgery import set_mjx_custom_options, set_robot_starting_position
from puppax_torch.model.terrain import add_heightfield_to_model, generate_heights

__all__ = ["CompiledModel", "RobotModel", "load_model", "add_boxes_to_model",
           "add_heightfield_to_model", "generate_heights", "set_mjx_custom_options",
           "set_robot_starting_position"]
