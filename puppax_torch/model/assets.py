"""Model assets: the bundled mesh-free Pupper v3 MJCF, read in place.

Counterpart of ``puppax/model/assets.py``. The XML stays where the JAX
package keeps it; only the table writer (``tables.py``) compiles it. The
terrain surgery (``surgery.py``, ``terrain.py``) edits the tree that
``pupper_xml_tree`` returns.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

BUNDLED_XML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "puppax", "model", "pupper_v3.xml",
)


def pupper_xml_tree() -> ET.ElementTree:
    """ElementTree of the bundled physics-equivalent (mesh-free) model."""
    return ET.parse(BUNDLED_XML)


def pupper_xml() -> str:
    """XML string of the bundled physics-equivalent model."""
    return ET.tostring(pupper_xml_tree().getroot(), encoding="unicode")
