"""Two models whose contacts the emitter once refused, against puppax's.

* A solimp power other than 2: the bundled Pupper with ``solimp="0.9 0.95
  0.001 0.5 3"`` on its 8 spheres, so its plane-sphere pairs carry power
  2.5 and its sphere-sphere pairs 3 (MuJoCo mixes the two geoms'). The
  emitter writes the power as the math library's pow (``soa.pow_const``:
  torch ``pow``, C ``powf``); power 2 keeps its ``x * x``.
* Boxes whose pairs differ in their contact parameters: the Pupper with
  two world boxes, the second with ``solref="0.03 0.7"``. The box loop then
  reads each box's contact constants from its table row
  (``soa._contact_constants``), as it reads the box's pose.

Both models reach the port as the JAX package reaches them, through
``env.path``; their tables are committed (``python -m
puppax_torch.model.tables --set env.path=<file>`` on the XML these helpers
write). Each emission's plain version (the torch rows) is held against
JAX's emission (``puppax.physics.soa._emit_substeps``) at the suite's
tolerances (qpos 5e-5, scaled qvel 5e-4, contact distances 5e-5), and the
g++ build of each one-thread K1 against the plain version: the power
model's bit for bit through the host's math (``sqrtf``, ``sinf``,
``cosf``, ``expf`` and ``powf`` of the C library on both sides), the box
model's at the parity tolerances.
"""

import ctypes
import ctypes.util
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.physics import soa as jsoa
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.kernels import build, cgen
from puppax_torch.model import assets, obstacles
from puppax_torch.physics import soa

torch.set_num_threads(1)

SOLIMP = "0.9 0.95 0.001 0.5 3"
BOX_SOLREF = "0.03 0.7"


def solimp_pupper_xml() -> str:
    """The bundled Pupper with ``SOLIMP`` on every sphere."""
    tree = assets.pupper_xml_tree()
    spheres = [g for g in tree.getroot().iter("geom") if g.get("type") == "sphere"]
    assert len(spheres) == 8
    for g in spheres:
        g.set("solimp", SOLIMP)
    return ET.tostring(tree.getroot(), encoding="unicode")


def two_box_pupper_xml() -> str:
    """The bundled Pupper with two world boxes, the second with
    ``BOX_SOLREF``."""
    tree = assets.pupper_xml_tree()
    obstacles.emit_boxes(tree.getroot().find("worldbody"), [(0.3, 0.0, 0.0), (-0.3, 0.1, 0.5)],
                         height=0.05, depth=0.4, length=0.4)
    boxes = [g for g in tree.getroot().iter("geom") if g.get("type") == "box"]
    boxes[1].set("solref", BOX_SOLREF)
    return ET.tostring(tree.getroot(), encoding="unicode")


@pytest.fixture(scope="module", params=["solimp", "boxes"])
def model(request, tmp_path_factory):
    """(name, the port's env, JAX's env), both from ``path=`` (1 substep)."""
    xml = solimp_pupper_xml() if request.param == "solimp" else two_box_pupper_xml()
    path = tmp_path_factory.mktemp(request.param) / f"{request.param}.xml"
    path.write_text(xml)
    tenv = PupperV3Env(path=str(path), device="cpu", **H.env_kwargs(1))
    jenv = JaxEnv(path=str(path), reward_config=get_config(), **H.env_kwargs(1))
    return request.param, tenv, jenv


def _states(name, env, seed):
    rng = np.random.RandomState(seed)
    qpos, qvel, ctrl = H.random_states(env.model, rng)
    if name == "boxes":
        qpos = H.place_over_boxes(env.model, qpos, rng, range(0, H.B, 2))
        assert H.box_contacts(env.model, qpos).sum() >= 2
    return qpos, qvel, ctrl


def test_the_models_reach_the_new_emission(model):
    """The power model's pairs carry 2.5 and 3 and its K1 body calls
    ``powf``; the box model's table holds each box's contact constants,
    which differ between the boxes."""
    name, tenv, _ = model
    s = tenv._s
    if name == "solimp":
        powers = {p.kind: float(p.solimp[4]) for p in s.pairs}
        assert powers == {"ps": 2.5, "ss": 3.0}
        assert "powf(" in cgen.physics_step_body(s, 1)
        return
    bx = s.boxes
    assert bx.params and bx.n == 2
    width = soa.BOX_POSE_COLUMNS + soa.N_CONTACT_CONSTANTS * len(bx.spheres)
    assert all(len(row) == width for row in bx.table)
    k = soa.BOX_POSE_COLUMNS  # the first sphere's stiffness K
    assert bx.table[0][k] != bx.table[1][k]
    assert "powf(" not in cgen.physics_step_body(s, 1)  # power 2: x * x


def _jrows(x):
    return [jnp.asarray(r) for r in np.asarray(x, np.float32).T]


def test_emission_matches_jax(model):
    """One substep and the final integrate: the plain K1
    (``soa.physics_step_rows``, the torch rows) against JAX's emission on
    the same states (nominal DR rows), with contacts penetrating."""
    name, tenv, jenv = model
    js, ts = jenv._cv_core._s, tenv._s
    qpos, qvel, ctrl = _states(name, tenv, 3)
    jdr = {k: _jrows(v) for k, v in jsoa.dr_inputs(jenv.model, js, H.B).items()}
    tdr = {k: list(v.t().contiguous()) for k, v in soa.dr_inputs(tenv.model, ts, H.B).items()}
    with jax.disable_jit():
        jq, jv = _jrows(qpos), _jrows(qvel)
        qp, vp, fw = jsoa._emit_substeps(js, jq, jv, _jrows(ctrl), jdr, 1)
        jq2, jv2 = jsoa._emit_integrate(js, qp, vp, fw["qacc"])
        jdist = fw["con_dist"]
    dr = soa.dr_rows_block(ts, soa.dr_inputs(tenv.model, ts, H.B))
    got_q, got_v, caches = (x.numpy().T for x in soa.physics_step_rows(
        ts, 1, *[torch.from_numpy(np.ascontiguousarray(x.T)) for x in (qpos, qvel, ctrl)], dr))

    def mat(xs):
        return np.stack([np.asarray(jsoa.materialize(x, jq[0])) for x in xs], 1)

    want_q, want_v, dist = mat(jq2), mat(jv2), mat(jdist)
    np.testing.assert_allclose(got_q, want_q, atol=5e-5, rtol=0, err_msg="qpos")
    scale = np.maximum(1.0, np.abs(want_v).max(axis=1, keepdims=True))
    np.testing.assert_allclose(got_v / scale, want_v / scale, atol=5e-4, rtol=0, err_msg="qvel")
    r0, n = ts.cache_rows["con_dist"]
    np.testing.assert_allclose(caches[:, r0:r0 + n], dist, atol=5e-5, rtol=0, err_msg="con_dist")
    assert (dist < 0).any()


def _libm(name: str, nargs: int = 1):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float] * nargs
    return fn


def _host_math(monkeypatch):
    """The plain version's math functions as the C library's (float32 in,
    float32 out, each correctly rounded or libm's own), element by element,
    as the g++ build calls them."""
    def elementwise(fn):
        def op(x):
            if not isinstance(x, torch.Tensor):
                return fn(x)
            return torch.tensor([fn(a) for a in x.tolist()], dtype=torch.float32)
        return op

    sqrtf, sinf, cosf, expf, powf = (_libm(n, 2 if n == "powf" else 1)
                                    for n in ("sqrtf", "sinf", "cosf", "expf", "powf"))
    for name, fn in (("sqrt", sqrtf), ("sin", sinf), ("cos", cosf), ("exp", expf)):
        op = elementwise(fn)
        monkeypatch.setattr(soa, name, lambda x, op=op, orig=getattr(soa, name):
                            op(x) if isinstance(x, torch.Tensor) else orig(x))
    monkeypatch.setattr(soa, "rsqrt", lambda x, sq=soa.sqrt: 1.0 / sq(x))
    pow_orig = soa.pow_const
    monkeypatch.setattr(soa, "pow_const", lambda x, p: torch.tensor(
        [powf(a, p) for a in x.tolist()], dtype=torch.float32)
        if isinstance(x, torch.Tensor) else pow_orig(x, p))


@pytest.fixture(scope="module")
def k1_host(model, tmp_path_factory):
    name, tenv, _ = model
    body = cgen.physics_step_body(tenv._s, 1)
    return build.host_library(build.PHYSICS_STEP, body, tmp_path_factory.mktemp(f"k1_{name}"))


def test_gxx_k1_matches_plain(model, k1_host, monkeypatch):
    """The g++ one-thread K1 against the plain version on the same blocks:
    the power model bit for bit with the plain version on the host's math,
    the box model at the parity tolerances."""
    name, tenv, _ = model
    s = tenv._s
    qpos, qvel, ctrl = _states(name, tenv, 5)
    dr = soa.dr_rows_block(s, soa.dr_inputs(tenv.model, s, H.B))
    blocks = [torch.from_numpy(np.ascontiguousarray(x.T)) for x in (qpos, qvel, ctrl)] + [dr]
    outs = [torch.empty((n, H.B)) for n in (s.nq, s.nv, s.ncache)]
    assert k1_host.physics_step_host(*[t.data_ptr() for t in blocks + outs], H.B) == 0
    if name == "solimp":
        _host_math(monkeypatch)
    want = soa.physics_step_rows(s, 1, *blocks)
    if name == "solimp":
        for g, w, what in zip(outs, want, ("qpos", "qvel", "caches")):
            np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32),
                                          err_msg=what)
    else:
        H.assert_physics_outputs_close([o.numpy() for o in outs], [w.numpy() for w in want], s,
                                       "K1[boxes] g++ vs plain")
