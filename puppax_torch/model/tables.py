"""Host-side table writer: compile the MJCF with mujoco, store it as JSON.

The port carries the compiled model across as data. This module is the
only place in ``puppax_torch`` that imports ``mujoco``; it reproduces
``puppax/model/mjcf.py::put_model`` (the same tables, pair lists and
caps, the heightfield's grid) and writes the JSON beside ``mjcf.py``:

    python -m puppax_torch.model.tables --write      # pupper_v3_tables.json
    python -m puppax_torch.model.tables --config cfg.json [--set env.KEY=VALUE ...]
    python -m puppax_torch.model.tables --set env.path=robot.xml

``--config`` / ``--set`` apply the config's terrain surgery to its model
(the bundled one, or ``env.path``'s) as ``scripts/train.py`` does (the
boxes of ``obstacles.add_boxes_to_model``, then
``terrain.add_heightfield_to_model``); an ``env.path`` without a terrain
is compiled as it is, as ``puppax/model/mjcf.py::load_model`` compiles it.
The writer writes ``mjcf.tables_path(cfg.env)``, the file the port's env
reads for that config on a host without mujoco.
"""

from __future__ import annotations

import argparse
import itertools
import json
import xml.etree.ElementTree as ET

import numpy as np

from puppax_torch.model import assets
from puppax_torch.model.mjcf import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_HFIELD, GEOM_PLANE, GEOM_SPHERE, JNT_FREE, JNT_HINGE,
    LEAF_FIELDS, MJ_FIELDS, TABLES_PATH, mjcf_digest, tables_path,
)


def _collision_pairs(m):
    """Candidate pairs with MuJoCo's filter, in ``mjcf._collision_pairs``'s
    order and with its raises: plane-sphere, sphere-sphere, sphere-box
    (sphere first, box second; the boxes are world geoms, so the pairs come
    box by box), hfield-sphere, plane-capsule, sphere-capsule and
    capsule-capsule, each pair with the geom of the lower type first."""
    kinds = {(GEOM_PLANE, GEOM_SPHERE): "ps", (GEOM_SPHERE, GEOM_SPHERE): "ss",
             (GEOM_SPHERE, GEOM_BOX): "bs", (GEOM_HFIELD, GEOM_SPHERE): "hs",
             (GEOM_PLANE, GEOM_CAPSULE): "pc", (GEOM_SPHERE, GEOM_CAPSULE): "sc",
             (GEOM_CAPSULE, GEOM_CAPSULE): "cc"}
    supported = {GEOM_PLANE, GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_HFIELD}
    out = {k: [] for k in kinds.values()}
    for g1, g2 in itertools.combinations(range(m.ngeom), 2):
        if not (
            (m.geom_contype[g1] & m.geom_conaffinity[g2])
            or (m.geom_contype[g2] & m.geom_conaffinity[g1])
        ):
            continue
        b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
        if b1 == b2:
            continue
        p1, p2 = int(m.body_parentid[b1]), int(m.body_parentid[b2])
        if (p2 == b1 or p1 == b2) and b1 != 0 and b2 != 0:
            continue
        if int(m.body_weldid[b1]) == int(m.body_weldid[b2]):
            continue
        t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
        if t1 not in supported or t2 not in supported:
            raise NotImplementedError(f"geom pair type ({t1},{t2}) unsupported")
        (ta, ga), (tb, gb) = sorted(((t1, g1), (t2, g2)))
        kind = kinds.get((ta, tb))
        if kind is not None:
            out[kind].append([ga, gb])
        elif ta == GEOM_PLANE and tb == GEOM_BOX:
            raise NotImplementedError("plane-box collisions unsupported")
        elif GEOM_HFIELD in (ta, tb):
            raise NotImplementedError(f"hfield pair ({ta},{tb}) unsupported")
        else:
            raise NotImplementedError(f"pair ({ta},{tb}) unsupported")
    return out


def _custom_numeric(m, name: str, default: int) -> int:
    for i in range(m.nnumeric):
        if m.numeric(i).name == name:
            return int(m.numeric_data[m.numeric_adr[i]])
    return default


def tables_from_mjmodel(m) -> dict:
    """The JSON-ready tables of a compiled ``mujoco.MjModel``."""
    if m.njnt and not all(int(t) in (JNT_FREE, JNT_HINGE) for t in m.jnt_type):
        raise NotImplementedError("only free + hinge joints supported")
    if np.any(m.body_jntnum > 1):
        raise NotImplementedError("at most one joint per body supported")
    pairs = _collision_pairs(m)
    if int(m.nhfield) > 1:
        raise NotImplementedError("at most one heightfield supported")
    hf = int(m.nhfield) == 1

    def ints(x):
        return [int(v) for v in np.asarray(x).reshape(-1)]

    def f32(x):
        return np.asarray(x, np.float32).astype(np.float64).tolist()

    leaves = {
        "gravity": m.opt.gravity, "qpos0": m.qpos0,
        "key_qpos": m.key_qpos[0] if m.nkey else m.qpos0,
        "actuator_gainprm": m.actuator_gainprm[:, :3],
        "actuator_biasprm": m.actuator_biasprm[:, :3],
    }
    robot = {
        "nq": int(m.nq), "nv": int(m.nv), "nu": int(m.nu),
        "nbody": int(m.nbody), "njnt": int(m.njnt), "ngeom": int(m.ngeom),
        "nsite": int(m.nsite),
        "body_parentid": ints(m.body_parentid),
        "body_rootid": ints(m.body_rootid),
        "body_jntid": ints(np.where(m.body_jntnum > 0, m.body_jntadr, -1)),
        "jnt_type": ints(m.jnt_type), "jnt_qposadr": ints(m.jnt_qposadr),
        "jnt_dofadr": ints(m.jnt_dofadr), "jnt_bodyid": ints(m.jnt_bodyid),
        "jnt_limited": ints(m.jnt_limited.astype(int)),
        "dof_bodyid": ints(m.dof_bodyid), "geom_bodyid": ints(m.geom_bodyid),
        "geom_type": ints(m.geom_type), "site_bodyid": ints(m.site_bodyid),
        "actuator_jntid": ints(m.actuator_trnid[:, 0]),
        "dof_frictional": ints(np.nonzero(m.dof_frictionloss > 0)[0]),
        "pairs_plane_sphere": pairs["ps"],
        "pairs_sphere_sphere": pairs["ss"],
        "pairs_sphere_box": pairs["bs"], "pairs_hfield_sphere": pairs["hs"],
        "pairs_plane_capsule": pairs["pc"], "pairs_sphere_capsule": pairs["sc"],
        "pairs_capsule_capsule": pairs["cc"],
        "hfield_nrow": int(m.hfield_nrow[0]) if hf else 0,
        "hfield_ncol": int(m.hfield_ncol[0]) if hf else 0,
        "max_contact_points": _custom_numeric(m, "max_contact_points", 8),
        "max_geom_pairs": _custom_numeric(m, "max_geom_pairs", 8),
        "timestep": float(m.opt.timestep), "impratio": float(m.opt.impratio),
        "solver_iterations": int(m.opt.iterations),
        "ls_iterations": int(m.opt.ls_iterations),
        "tolerance": float(m.opt.tolerance),
        "ls_tolerance": float(m.opt.ls_tolerance),
        "meaninertia": float(m.stat.meaninertia),
    }
    for k in LEAF_FIELDS:
        robot[k] = f32(leaves[k] if k in leaves else getattr(m, k))
    mj = {
        k: np.asarray(
            m.opt.gravity if k == "gravity" else getattr(m, k), np.float64
        ).tolist()
        for k in MJ_FIELDS
    }
    if hf:  # the grid in memory order (row 0 at y = -ry), as put_model keeps it
        grid = np.asarray(m.hfield_data).reshape(int(m.hfield_nrow[0]), int(m.hfield_ncol[0]))
        robot["hfield_data"] = f32(grid)
        robot["hfield_size"] = f32(m.hfield_size[0])
        mj["hfield_data"] = np.asarray(grid, np.float64).tolist()
        mj["hfield_size"] = np.asarray(m.hfield_size[0], np.float64).tolist()
    names = {
        "body": [m.body(i).name for i in range(m.nbody)],
        "site": [m.site(i).name for i in range(m.nsite)],
        "body_geomadr": ints(m.body_geomadr),
        "body_geomnum": ints(m.body_geomnum),
    }
    return {"robot": robot, "mj": mj, "names": names}


def _write(m, out_path: str) -> str:
    with open(out_path, "w") as f:
        json.dump(tables_from_mjmodel(m), f, indent=0)
        f.write("\n")
    return out_path


def write_tables(out_path: str = TABLES_PATH) -> str:
    """Compile the bundled MJCF and write its tables to ``out_path``."""
    import mujoco

    return _write(mujoco.MjModel.from_xml_path(assets.BUNDLED_XML), out_path)


def config_xml(env_cfg) -> str:
    """The XML string of an ``EnvConfig``'s model: its MJCF (the bundled
    model, or ``env_cfg.path``) with the config's boxes, then its
    heightfield, added as ``scripts/train.py`` adds them (so the geom ids
    are the JAX package's); another MJCF without a terrain as its file
    holds it."""
    from puppax_torch.model import obstacles, terrain

    if env_cfg.path is not None:
        mjcf_digest(env_cfg.path)  # raises for an MJCF that reads other files
        if not (env_cfg.n_obstacles or env_cfg.heightfield):
            with open(env_cfg.path) as f:
                return f.read()
    tree = assets.pupper_xml_tree() if env_cfg.path is None else ET.parse(env_cfg.path)
    if env_cfg.n_obstacles:
        tree = obstacles.add_boxes_to_model(
            tree, n_boxes=env_cfg.n_obstacles, x_range=env_cfg.obstacle_x_range,
            y_range=env_cfg.obstacle_y_range, height=env_cfg.obstacle_height,
            length=env_cfg.obstacle_length, seed=env_cfg.obstacle_seed,
        )
    if env_cfg.heightfield:
        tree = terrain.add_heightfield_to_model(
            tree, nrow=env_cfg.heightfield_nrow, ncol=env_cfg.heightfield_ncol,
            size=env_cfg.heightfield_size, seed=env_cfg.heightfield_seed,
        )
    return ET.tostring(tree.getroot(), encoding="unicode")


def write_config_tables(env_cfg, out_path: str = None) -> str:
    """Compile an ``EnvConfig``'s model (another MJCF, a terrain, or both)
    and write its tables to ``out_path`` (default:
    ``mjcf.tables_path(env_cfg)``)."""
    import mujoco

    if env_cfg.path is None and not (env_cfg.n_obstacles or env_cfg.heightfield):
        raise ValueError("the config has no terrain and no env.path: the flat model's "
                         "tables are --write's")
    out_path = out_path or tables_path(env_cfg)
    return _write(mujoco.MjModel.from_xml_string(config_xml(env_cfg)), out_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate the bundled pupper_v3_tables.json")
    ap.add_argument("--config", default=None,
                    help="an experiment config JSON: write its terrain's tables")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted-path override of the config, e.g. env.obstacle_seed=3 "
                         "or env.path=robot.xml")
    args = ap.parse_args(argv)
    if args.config is None and not args.set:
        if not args.write:
            ap.error("nothing to do: pass --write or --config")
        print(write_tables())
        return
    from puppax_torch.configs import experiment as exp

    cfg = exp.ExperimentConfig()
    if args.config:
        with open(args.config) as f:
            cfg = exp.from_dict(json.load(f))
    if args.set:
        cfg = exp.apply_overrides(cfg, dict(exp.parse_override(s) for s in args.set))
    print(write_config_tables(cfg.env))


if __name__ == "__main__":
    main()
