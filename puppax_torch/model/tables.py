"""Host-side table writer: compile the MJCF with mujoco, store it as JSON.

The port carries the compiled model across as data. This module is the
only place in ``puppax_torch`` that imports ``mujoco``; it reproduces
``puppax/model/mjcf.py::put_model`` (the same tables, pair lists and
caps) for the bundled flat model and writes ``pupper_v3_tables.json``
beside ``mjcf.py``:

    python -m puppax_torch.model.tables --write
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np

from puppax_torch.model import assets
from puppax_torch.model.mjcf import (
    GEOM_PLANE, GEOM_SPHERE, JNT_FREE, JNT_HINGE, LEAF_FIELDS, MJ_FIELDS,
    TABLES_PATH,
)


def _collision_pairs(m):
    """Candidate pairs with MuJoCo's filter (``mjcf._collision_pairs``).

    Only the flat model's plane-sphere and sphere-sphere kinds are ported.
    """
    kinds = {(GEOM_PLANE, GEOM_SPHERE): "ps", (GEOM_SPHERE, GEOM_SPHERE): "ss"}
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
        (ta, ga), (tb, gb) = sorted(
            ((int(m.geom_type[g1]), g1), (int(m.geom_type[g2]), g2))
        )
        kind = kinds.get((ta, tb))
        if kind is None:
            raise NotImplementedError(
                f"geom pair type ({ta},{tb}) is not ported yet (ROADMAP queue 1, terrain)"
            )
        out[kind].append([ga, gb])
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
        "pairs_sphere_box": [], "pairs_hfield_sphere": [],
        "pairs_plane_capsule": [], "pairs_sphere_capsule": [],
        "pairs_capsule_capsule": [], "hfield_nrow": 0, "hfield_ncol": 0,
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
    names = {
        "body": [m.body(i).name for i in range(m.nbody)],
        "site": [m.site(i).name for i in range(m.nsite)],
        "body_geomadr": ints(m.body_geomadr),
        "body_geomnum": ints(m.body_geomnum),
    }
    return {"robot": robot, "mj": mj, "names": names}


def write_tables(out_path: str = TABLES_PATH) -> str:
    """Compile the bundled MJCF and write its tables to ``out_path``."""
    import mujoco

    m = mujoco.MjModel.from_xml_path(assets.BUNDLED_XML)
    with open(out_path, "w") as f:
        json.dump(tables_from_mjmodel(m), f, indent=0)
        f.write("\n")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate the bundled pupper_v3_tables.json")
    args = ap.parse_args(argv)
    if not args.write:
        ap.error("nothing to do: pass --write")
    print(write_tables())


if __name__ == "__main__":
    main()
