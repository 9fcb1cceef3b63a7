"""Obstacle terrain: long thin boxes scattered on the floor, pre-compile.

Counterpart of ``puppax/model/obstacles.py``. ``sample_box_layout`` draws
one ``(x, y, yaw)`` triple per box from ``random.Random(seed)`` in the same
order (x, then y, then yaw, box by box), and ``emit_boxes`` writes each box
as a world geom with the same attribute strings, so ``add_boxes_to_model``
gives the JAX package's XML for the same arguments. One layout is drawn per
compiled model: every env of a batch shares the terrain.
"""

from __future__ import annotations

import math
import random
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

# (x, y, yaw) per box; yaw in radians about +z.
BoxLayout = List[Tuple[float, float, float]]


def sample_box_layout(n_boxes: int, x_range: Tuple[float, float],
                      y_range: Tuple[float, float], seed: int = 0) -> BoxLayout:
    """A deterministic layout: seed once, then per box x, y and yaw."""
    rng = random.Random(seed)
    return [
        (rng.uniform(*x_range), rng.uniform(*y_range), rng.uniform(-math.pi, math.pi))
        for _ in range(n_boxes)
    ]


def yaw_quat(yaw: float) -> List[float]:
    """Quaternion (w, x, y, z) of a rotation of ``yaw`` radians about +z."""
    return [math.cos(yaw / 2.0), 0.0, 0.0, math.sin(yaw / 2.0)]


def emit_boxes(worldbody: ET.Element, layout: Sequence[Tuple[float, float, float]],
               height: float = 0.02, depth: float = 0.02, length: float = 3.0,
               group: str = "0") -> None:
    """Append one collision box geom per layout entry to ``worldbody``."""
    for i, (x, y, yaw) in enumerate(layout):
        ET.SubElement(
            worldbody,
            "geom",
            name=f"box_geom_{i}",
            pos=f"{x} {y} 0",
            quat=" ".join(str(v) for v in yaw_quat(yaw)),
            type="box",
            size=f"{depth / 2.0} {length / 2.0} {height}",
            rgba="0.1 0.5 0.8 1",
            conaffinity="1",
            contype="1",
            condim="3",
            group=group,
        )


def add_boxes_to_model(tree: ET.ElementTree, n_boxes: int, x_range: Tuple[float, float],
                       y_range: Tuple[float, float], height: float = 0.02, depth: float = 0.02,
                       length: float = 3.0, group: str = "0", seed: int = 0) -> ET.ElementTree:
    """Scatter ``n_boxes`` long thin collision boxes on the worldbody floor."""
    worldbody = tree.getroot().find("worldbody")
    layout = sample_box_layout(n_boxes, x_range, y_range, seed=seed)
    emit_boxes(worldbody, layout, height=height, depth=depth, length=length, group=group)
    return tree
