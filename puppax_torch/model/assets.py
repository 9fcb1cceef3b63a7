"""Model assets: the bundled mesh-free Pupper v3 MJCF, read in place.

Counterpart of ``puppax/model/assets.py``. The XML stays where the JAX
package keeps it; only the table writer (``tables.py``) compiles it.
"""

from __future__ import annotations

import os

BUNDLED_XML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "puppax", "model", "pupper_v3.xml",
)
