"""Pre-compile MJCF XML surgery: the contact caps and the starting pose.

Counterpart of ``puppax/model/surgery.py``: both functions edit an
``xml.etree`` tree before the one host-side MuJoCo compile
(``tables.py``), and give the JAX package's XML for the same arguments.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import List, Optional


def set_mjx_custom_options(
    tree: ET.ElementTree, max_contact_points: int, max_geom_pairs: int
) -> Optional[ET.ElementTree]:
    """Set the contact caps in the model's ``<custom>`` numerics. Returns
    the tree, or None when the model has no ``<custom>`` section."""
    custom = tree.getroot().find("custom")
    if custom is None:
        return None
    values = {
        "max_contact_points": max_contact_points,
        "max_geom_pairs": max_geom_pairs,
    }
    for numeric in custom.findall("numeric"):
        name = numeric.get("name")
        if name in values:
            numeric.set("data", str(values[name]))
    return tree


def set_robot_starting_position(
    tree: ET.ElementTree,
    starting_pos: List[float],
    starting_quat: Optional[List[float]] = None,
) -> ET.ElementTree:
    """Rewrite base_link's pos (and quat) and the 'home' keyframe's qpos
    to a new starting pose."""
    body = tree.find(".//worldbody/body[@name='base_link']")
    body.set("pos", " ".join(str(v) for v in starting_pos[:3]))
    if starting_quat is not None:
        body.set("quat", " ".join(str(v) for v in starting_quat[:4]))

    key = tree.find(".//keyframe/key[@name='home']")
    qpos = [float(v) for v in re.split(r"\s+", key.get("qpos").strip())]
    qpos[:3] = list(starting_pos)
    if starting_quat is not None:
        qpos[3:7] = list(starting_quat)
    key.set("qpos", " ".join(str(v) for v in qpos))
    return tree
