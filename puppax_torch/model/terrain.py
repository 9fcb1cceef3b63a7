"""Heightfield terrain: a seeded rough grid added to the MJCF, pre-compile.

Counterpart of ``puppax/model/terrain.py``. The grid is drawn with the
same ``np.random.default_rng(seed)`` draws, the spawn disc is flattened
alike, and the ``<hfield elevation="...">`` attribute is written top row
first with ``%.6f``, so the XML string equals the JAX package's for the
same arguments. MuJoCo min-max normalizes the elevations to [0, 1]; the
generated heights already span [0, 1], so the compiled grid is the
generated one, with memory row r at y = -ry + 2 ry r / (nrow - 1).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Tuple

import numpy as np


def generate_heights(nrow: int, ncol: int, seed: int = 0, coarse: int = 5,
                     roughness: float = 0.25) -> np.ndarray:
    """Smooth random terrain in [0, 1]: a coarse uniform grid bilinearly
    upsampled to (nrow, ncol), plus per-node jitter of relative amplitude
    ``roughness``. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(coarse, coarse))
    rows = np.linspace(0.0, coarse - 1.0, nrow)
    cols = np.linspace(0.0, coarse - 1.0, ncol)
    ir = np.clip(np.floor(rows).astype(int), 0, coarse - 2)
    ic = np.clip(np.floor(cols).astype(int), 0, coarse - 2)
    fr = (rows - ir)[:, None]
    fc = (cols - ic)[None, :]
    h = (
        base[ir][:, ic] * (1 - fr) * (1 - fc)
        + base[ir][:, ic + 1] * (1 - fr) * fc
        + base[ir + 1][:, ic] * fr * (1 - fc)
        + base[ir + 1][:, ic + 1] * fr * fc
    )
    h = h + rng.uniform(-roughness, roughness, size=(nrow, ncol))
    h -= h.min()
    peak = h.max()
    if peak > 0:
        h /= peak
    return h


def add_heightfield_to_model(
    tree: ET.ElementTree,
    nrow: int = 32,
    ncol: int = 32,
    size: Tuple[float, float, float, float] = (4.0, 4.0, 0.04, 0.01),
    heights: np.ndarray = None,
    seed: int = 0,
    name: str = "terrain",
    flat_radius: float = 0.35,
) -> ET.ElementTree:
    """Add a rough-ground heightfield and its world geom to the tree.

    ``size`` is MuJoCo's (radius_x, radius_y, elevation_z, base_z). The
    nodes within ``flat_radius`` of the origin are set to 0, so a
    randomized start pose does not spawn inside a bump. ``heights``
    (nrow, ncol, in [0, 1], row 0 at y = -ry) overrides the generated grid.
    """
    if heights is None:
        heights = generate_heights(nrow, ncol, seed=seed)
    heights = np.asarray(heights, float)
    assert heights.shape == (nrow, ncol), heights.shape
    rx, ry = float(size[0]), float(size[1])
    ys = np.linspace(-ry, ry, nrow)[:, None]
    xs = np.linspace(-rx, rx, ncol)[None, :]
    heights = np.where(xs**2 + ys**2 < flat_radius**2, 0.0, heights)

    root = tree.getroot()
    asset = root.find("asset")
    if asset is None:
        asset = ET.SubElement(root, "asset")
    # the elevation attribute is top row first: flip the memory order
    elevation = " ".join(f"{v:.6f}" for v in heights[::-1].ravel())
    ET.SubElement(
        asset, "hfield", name=name, nrow=str(nrow), ncol=str(ncol),
        size=" ".join(str(float(s)) for s in size), elevation=elevation,
    )
    ET.SubElement(
        root.find("worldbody"), "geom", name=f"{name}_geom", type="hfield", hfield=name,
        pos="0 0 0", conaffinity="1", contype="1", condim="3", rgba="0.4 0.35 0.3 1",
    )
    return tree
