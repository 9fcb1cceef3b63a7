"""The compiled robot model as plain data: ``RobotModel`` and ``load_model``.

Counterpart of ``puppax/model/mjcf.py``. There the MuJoCo C compiler runs
host-side and its tables become a flax pytree. Here the same tables are
read from JSON written once on a host with ``mujoco`` (``tables.py``):
``pupper_v3_tables.json`` for the bundled flat model, and one committed
file per terrain and per other MJCF (``env.path``; ``config_tables_path``),
so loading a model needs neither mujoco nor jax, and the card's host never
compiles one.

``RobotModel`` is a frozen dataclass: static topology as hashable tuples,
numeric parameters as float32 numpy arrays. Domain randomization swaps six
leaves for batched ``(B, ...)`` torch tensors (``with_leaves``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np

# mujoco enum values (mjtGeom / mjtJoint)
GEOM_PLANE = 0
GEOM_HFIELD = 1
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_BOX = 6
JNT_FREE = 0
JNT_HINGE = 3

TABLES_PATH = os.path.join(os.path.dirname(__file__), "pupper_v3_tables.json")

# the six leaves domain randomization batches over the env axis
DR_LEAVES = (
    "geom_friction",
    "actuator_gainprm",
    "actuator_biasprm",
    "body_ipos",
    "body_inertia",
    "body_mass",
)

STATIC_FIELDS = (
    "nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite",
    "body_parentid", "body_rootid", "body_jntid", "jnt_type", "jnt_qposadr",
    "jnt_dofadr", "jnt_bodyid", "jnt_limited", "dof_bodyid", "geom_bodyid",
    "geom_type", "site_bodyid", "actuator_jntid", "dof_frictional",
    "pairs_plane_sphere", "pairs_sphere_sphere", "pairs_sphere_box",
    "max_contact_points", "max_geom_pairs", "timestep", "impratio",
    "solver_iterations", "ls_iterations", "tolerance", "ls_tolerance",
    "meaninertia", "hfield_nrow", "hfield_ncol", "pairs_hfield_sphere",
    "pairs_plane_capsule", "pairs_sphere_capsule", "pairs_capsule_capsule",
)

LEAF_FIELDS = (
    "gravity", "qpos0", "key_qpos", "body_pos", "body_quat", "body_ipos",
    "body_iquat", "body_mass", "body_inertia", "jnt_pos", "jnt_axis",
    "jnt_range", "jnt_solref", "jnt_solimp", "jnt_margin", "dof_armature",
    "dof_damping", "dof_frictionloss", "dof_solref", "dof_solimp",
    "dof_invweight0", "body_invweight0", "geom_pos", "geom_quat", "geom_size",
    "geom_friction", "geom_solref", "geom_solimp", "site_pos",
    "actuator_gainprm", "actuator_biasprm", "actuator_forcerange",
)

# float64 MjModel fields the emitter's _Static bakes in (physics/soa.py)
MJ_FIELDS = (
    "gravity", "qpos0", "geom_solref", "geom_solimp", "geom_pos", "geom_quat",
    "geom_size", "actuator_biasprm", "actuator_forcerange", "body_invweight0",
    "body_pos", "body_quat", "body_iquat", "jnt_pos", "jnt_axis", "jnt_range",
    "jnt_solref", "jnt_solimp", "jnt_margin", "dof_armature", "dof_damping",
    "dof_frictionloss", "dof_solref", "dof_solimp", "dof_invweight0",
    "site_pos",
)


@dataclass(frozen=True)
class RobotModel:
    """Immutable numeric robot model (static topology + numeric leaves)."""

    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    body_parentid: tuple
    body_rootid: tuple
    body_jntid: tuple
    jnt_type: tuple
    jnt_qposadr: tuple
    jnt_dofadr: tuple
    jnt_bodyid: tuple
    jnt_limited: tuple
    dof_bodyid: tuple
    geom_bodyid: tuple
    geom_type: tuple
    site_bodyid: tuple
    actuator_jntid: tuple
    dof_frictional: tuple
    pairs_plane_sphere: tuple
    pairs_sphere_sphere: tuple
    pairs_sphere_box: tuple
    max_contact_points: int
    max_geom_pairs: int
    timestep: float
    impratio: float
    solver_iterations: int
    ls_iterations: int
    tolerance: float
    ls_tolerance: float
    meaninertia: float
    hfield_nrow: int
    hfield_ncol: int
    pairs_hfield_sphere: tuple
    pairs_plane_capsule: tuple
    pairs_sphere_capsule: tuple
    pairs_capsule_capsule: tuple
    gravity: Any
    qpos0: Any
    key_qpos: Any
    body_pos: Any
    body_quat: Any
    body_ipos: Any  # DR leaf
    body_iquat: Any
    body_mass: Any  # DR leaf
    body_inertia: Any  # DR leaf
    jnt_pos: Any
    jnt_axis: Any
    jnt_range: Any
    jnt_solref: Any
    jnt_solimp: Any
    jnt_margin: Any
    dof_armature: Any
    dof_damping: Any
    dof_frictionloss: Any
    dof_solref: Any
    dof_solimp: Any
    dof_invweight0: Any
    body_invweight0: Any
    geom_pos: Any
    geom_quat: Any
    geom_size: Any
    geom_friction: Any  # DR leaf
    geom_solref: Any
    geom_solimp: Any
    site_pos: Any
    actuator_gainprm: Any  # DR leaf
    actuator_biasprm: Any  # DR leaf
    actuator_forcerange: Any
    # the heightfield's float32 grid (nrow, ncol), memory order, and its
    # (4,) size; None without one
    hfield_data: Any = None
    hfield_size: Any = None

    def replace(self, **updates) -> "RobotModel":
        return dataclasses.replace(self, **updates)

    def tree_replace(self, updates: Dict[str, Any]) -> "RobotModel":
        """Dotted-path update; ``opt.timestep`` names the timestep field."""
        return self.replace(
            **{(k.split(".")[-1] if k.startswith("opt.") else k): v
               for k, v in updates.items()}
        )

    def with_leaves(self, **leaves) -> "RobotModel":
        """The model with domain-randomized leaves: each of the six DR
        leaves (``DR_LEAVES``) may be given as a ``(B, ...)`` array or
        tensor. Used to carry ``puppax``'s batched DR model across."""
        unknown = set(leaves) - set(DR_LEAVES)
        if unknown:
            raise KeyError(f"not a domain-randomized leaf: {sorted(unknown)}")
        return self.replace(**leaves)


@dataclass(frozen=True)
class MjTables:
    """The float64 MjModel tables the emitter reads (``soa._Static``)."""

    fields: Dict[str, np.ndarray]

    def __getattr__(self, name):
        try:
            return self.__dict__["fields"][name]
        except KeyError:
            raise AttributeError(name) from None


@dataclass(frozen=True)
class CompiledModel:
    """``RobotModel`` plus the float64 tables and the name -> id maps the
    env constructor resolves (``puppax/env/pupper.py:180-212``)."""

    robot: RobotModel
    mj: MjTables
    body_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    body_geomadr: Tuple[int, ...]
    body_geomnum: Tuple[int, ...]

    def body_id(self, name: str) -> int:
        if name not in self.body_names:
            raise KeyError(f"body {name!r} not found")
        return self.body_names.index(name)

    def site_id(self, name: str) -> int:
        if name not in self.site_names:
            raise KeyError(f"site {name!r} not found")
        return self.site_names.index(name)

    def body_geom_ids(self, name: str) -> np.ndarray:
        b = self.body_id(name)
        return self.body_geomadr[b] + np.arange(self.body_geomnum[b])


def _tuple(x):
    if isinstance(x, list):
        return tuple(_tuple(v) for v in x)
    return x


def tables_path(cfg) -> str:
    """Where an ``EnvConfig``'s model's tables live: the bundled flat
    model's, or those of its MJCF and terrain beside this module, whether or
    not the file exists (the writer's target). The file is named by 12 hex
    digits of sha256 over each part the model is made of: another MJCF's
    content (``env.path``, ``mjcf_<digest>``, ``mjcf_digest``), then
    ``n_obstacles`` and the ``obstacle*`` fields (``boxes_<digest>``), then
    the ``heightfield*`` fields (``hfield_<digest>``), as in
    ``pupper_v3_boxes_<digest>_tables.json`` (the bundled model) or
    ``mjcf_<digest>_tables.json`` (another MJCF)."""
    parts = []
    if cfg.path is not None:
        parts.append(f"mjcf_{mjcf_digest(cfg.path)}")
    if cfg.n_obstacles:
        parts.append(f"boxes_{_digest(_obstacle_fields(cfg))}")
    if cfg.heightfield:
        parts.append(f"hfield_{_digest(_heightfield_fields(cfg))}")
    if not parts:
        return TABLES_PATH
    prefix = "" if cfg.path is not None else "pupper_v3_"
    return os.path.join(os.path.dirname(__file__), f"{prefix}{'_'.join(parts)}_tables.json")


def mjcf_digest(path: str) -> str:
    """12 hex digits of sha256 over an MJCF file's canonical form (C14N 2.0
    with the text between elements stripped): the same model written twice,
    under any name and in any directory, keys the same tables. An MJCF that
    reads other files (``<include>``, a ``file=`` attribute: meshes,
    heightfields, textures) raises, since the digest would not see them."""
    import xml.etree.ElementTree as ET

    with open(path) as f:
        text = f.read()
    for el in ET.fromstring(text).iter():
        if el.tag == "include" or "file" in el.attrib:
            raise NotImplementedError(
                f"{path}: an MJCF that reads other files (<{el.tag}> with file=) is not "
                "carried across: its tables are keyed by the MJCF's own content only")
    canon = ET.canonicalize(xml_data=text, strip_text=True)
    return hashlib.sha256(canon.encode()).hexdigest()[:12]


def _digest(fields: dict) -> str:
    text = json.dumps(fields, sort_keys=True, default=list)
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def _obstacle_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name == "n_obstacles" or f.name.startswith("obstacle")}


def _heightfield_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name.startswith("heightfield")}


def _terrain_fields(cfg) -> dict:
    return {**(_obstacle_fields(cfg) if cfg.n_obstacles else {}),
            **(_heightfield_fields(cfg) if cfg.heightfield else {})}


def config_tables_path(cfg) -> str:
    """The committed tables of an ``EnvConfig``'s model (``tables_path``).
    Raises for a terrain or an MJCF without committed tables, naming the
    command that writes them where mujoco lives; never falls back to the
    flat model."""
    path = tables_path(cfg)
    if not os.path.exists(path):
        terrain = _terrain_fields(cfg)
        what = {**({"path": cfg.path} if cfg.path is not None else {}), **terrain}
        cmd = "python -m refport.model.tables" + (" --config <config.json>" if terrain
                                                       else "")
        if cfg.path is not None:
            cmd += f" --set env.path={cfg.path}"
        raise FileNotFoundError(
            f"no committed tables for the model {what} ({path}): write them where mujoco "
            f"is installed with `{cmd} [--set env.KEY=VALUE ...]` and commit the file")
    return path


def load_model(path: str = TABLES_PATH) -> CompiledModel:
    """Read a model's tables: the bundled flat Pupper v3 model's by
    default, or a terrain's or another MJCF's (``config_tables_path``)."""
    with open(path) as f:
        data = json.load(f)
    robot = data["robot"]
    kw = {k: _tuple(robot[k]) for k in STATIC_FIELDS}
    for k in LEAF_FIELDS:
        kw[k] = np.asarray(robot[k], np.float32)
    if robot["hfield_nrow"]:
        kw["hfield_data"] = np.asarray(robot["hfield_data"], np.float32)
        kw["hfield_size"] = np.asarray(robot["hfield_size"], np.float32)
    mj = MjTables({k: np.asarray(v, np.float64) for k, v in data["mj"].items()})
    names = data["names"]
    return CompiledModel(
        robot=RobotModel(**kw),
        mj=mj,
        body_names=tuple(names["body"]),
        site_names=tuple(names["site"]),
        body_geomadr=tuple(names["body_geomadr"]),
        body_geomnum=tuple(names["body_geomnum"]),
    )
