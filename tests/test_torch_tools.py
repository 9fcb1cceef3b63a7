"""The port's tools against ``puppax.tools`` on the same inputs, on the CPU.

Each tool of ``puppax_torch/tools`` (and ``train/checkpoint.py::
download_checkpoint``) runs beside its ``puppax`` counterpart: the
metrics sinks with a stub ``wandb`` module, the progress plot pixel for
pixel, the W&B checkpoint lookup with a stub ``wandb.Api``, the Hilbert
transform (1e-12), the matplotlib figure of ``plot_multi_series``, the
``Timer`` under one fake clock, ``trace`` on the CPU, rendering and video
writing through a stub ``mujoco.Renderer`` (no GL context is relied on
here), and, for the slice as a whole, ``visualize_policy``'s 14-step
rollout of the bundled flat model at the default env settings (5 physics
substeps, dt 0.02) against JAX's with the same policy weights: each
step's qpos within ``tests/test_torch_rollout.py``'s 2e-4, the commands
equal, the trajectory file complete. wandb is stubbed everywhere: no test
reaches the network.
"""

import json
import os
import shutil
import sys
import time
import types

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from puppax.configs import get_config
from puppax.env import PupperV3Env as JaxEnv
from puppax.tools import eval as jeval
from puppax.tools import metrics as jmetrics
from puppax.tools import plotting as jplotting
from puppax.tools import profiling as jprofiling
from puppax.tools import video as jvideo
from puppax.train import checkpoint as jcheckpoint
from puppax.train import networks as jnets
from puppax.train import running_statistics as jstats
from puppax_torch.configs import EnvConfig
from puppax_torch.env.pupper import PupperV3Env
from puppax_torch.model.tables import config_xml
from puppax_torch.tools import eval as teval
from puppax_torch.tools import metrics as tmetrics
from puppax_torch.tools import plotting as tplotting
from puppax_torch.tools import profiling as tprofiling
from puppax_torch.tools import video as tvideo
from puppax_torch.train import checkpoint as tcheckpoint
from puppax_torch.train import networks as tnets
from puppax_torch.train import running_statistics as tstats

torch.set_num_threads(1)

N_STEPS = 14  # two steps of each of the 7 commands


# ---- stubs ---------------------------------------------------------------


def _stub_wandb(run=True):
    """A ``wandb`` module that records ``log`` / ``log_model`` calls."""
    mod = types.ModuleType("wandb")
    mod.run = object() if run else None
    mod.calls = []
    mod.log = lambda metrics, step=None: mod.calls.append(("log", dict(metrics), step))
    mod.log_model = lambda path, name: mod.calls.append(("log_model", path, name))
    return mod


class StubRenderer:
    """``mujoco.Renderer`` without GL: each frame a constant image of its
    index; the scenes' qpos and cameras recorded."""

    made = []

    def __init__(self, model, height=240, width=320):
        self.shape, self.seen = (height, width, 3), []
        StubRenderer.made.append(self)

    def update_scene(self, data, camera=None):
        self.seen.append((np.array(data.qpos), camera))

    def render(self):
        return np.full(self.shape, len(self.seen), np.uint8)

    def close(self):
        pass


class NoGLRenderer:
    def __init__(self, *a, **k):
        raise OSError("gladLoadGL error")


@pytest.fixture
def no_encoders(monkeypatch):
    """No mediapy and no ffmpeg: ``write_video`` falls back to ``.npz``."""
    monkeypatch.setitem(sys.modules, "mediapy", None)
    monkeypatch.setattr(shutil, "which", lambda *_: None)


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in open(path)]


# ---- metrics ---------------------------------------------------------------


def _drive_logger(logger, ckpt):
    logger.log({"eval/episode_reward": 1.5, "nested": {"skip": 1}, "name": "x"}, step=10)
    logger.log({"training/sps": np.float32(3.25), "eval/episode_reward": 2}, step=20)
    logger.log_artifact(ckpt, name="checkpoint_20")


def test_metrics_logger_jsonl_and_wandb_calls(tmp_path, monkeypatch):
    """The JSONL records (``ts`` aside) and the W&B calls of the same
    ``log`` / ``log_artifact`` calls equal JAX's logger's."""
    calls = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        stub = _stub_wandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        logger = mod.MetricsLogger(jsonl_path=str(tmp_path / name / "m.jsonl"), use_wandb=True)
        _drive_logger(logger, str(tmp_path / "ckpt" / "20"))
        calls[name] = (_records(tmp_path / name / "m.jsonl"), stub.calls)
    assert calls["torch"] == calls["jax"]
    records, wandb_calls = calls["torch"]
    assert [r.get("step") for r in records] == [10, 20, None]
    assert [c[0] for c in wandb_calls] == ["log", "log", "log_model"]


@pytest.mark.parametrize("wandb_state", ["absent", "no run"])
def test_metrics_logger_without_a_wandb_run(tmp_path, monkeypatch, wandb_state):
    """``use_wandb=True`` with wandb missing or no live run: the JSONL sink
    alone, as JAX's logger does, and no raise."""
    stub = _stub_wandb(run=False)
    monkeypatch.setitem(sys.modules, "wandb", None if wandb_state == "absent" else stub)
    out = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        logger = mod.MetricsLogger(jsonl_path=str(tmp_path / name / "m.jsonl"), use_wandb=True)
        assert logger._wandb is None
        _drive_logger(logger, str(tmp_path / "ckpt"))
        out[name] = _records(tmp_path / name / "m.jsonl")
    assert out["torch"] == out["jax"] and len(out["torch"]) == 3
    assert stub.calls == []


def test_progress_fn_renders_the_plot(tmp_path):
    """``make_progress_fn(plot_path=...)`` writes the PNG at the first eval
    epoch and renders it again at the next; its curve lists are JAX's."""
    metrics = [(0, {"eval/episode_reward": 1.0, "eval/episode_reward_std": 0.1}),
               (100, {"training/sps": 5.0}),
               (200, {"eval/episode_reward": 2.5, "eval/episode_reward_std": 0.3})]
    progress = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        png = tmp_path / f"{name}.png"
        fn = mod.make_progress_fn(mod.MetricsLogger(), plot_path=str(png))
        fn(*metrics[0])
        assert png.exists()
        first = png.read_bytes()
        for m in metrics[1:]:
            fn(*m)
        assert png.read_bytes() != first  # re-rendered with the two-point curve
        progress[name] = fn
    for curve in ("x_data", "y_data", "ydataerr"):
        assert getattr(progress["torch"], curve) == getattr(progress["jax"], curve)
    assert progress["torch"].x_data == [0, 200] and len(progress["torch"].times) == 3


@pytest.mark.parametrize("n_points", [0, 1, 4])
def test_plot_progress_curve_pixel_for_pixel(tmp_path, n_points):
    import matplotlib.image as mpimg

    rng = np.random.RandomState(n_points)
    x = list(range(0, 1000 * n_points, 1000))
    y = list(rng.uniform(-5.0, 60.0, n_points))
    err = list(rng.uniform(0.0, 3.0, n_points))
    jmetrics.plot_progress_curve(x, y, err, str(tmp_path / "jax.png"))
    tmetrics.plot_progress_curve(x, y, err, str(tmp_path / "torch.png"))
    want = mpimg.imread(str(tmp_path / "jax.png"))
    got = mpimg.imread(str(tmp_path / "torch.png"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- download_checkpoint -----------------------------------------------------


class _Artifact:
    def __init__(self, name, downloads):
        self.name, self._downloads = name, downloads

    def download(self, path):
        self._downloads.append((self.name, path))


def _stub_wandb_api(runs):
    """A ``wandb`` module whose ``Api().runs(path)`` lists ``runs``: (name,
    artifact names) pairs; downloads recorded in ``mod.downloads``."""
    mod = _stub_wandb()
    mod.downloads, mod.paths = [], []

    class Run:
        def __init__(self, name, artifacts):
            self.name, self._artifacts = name, artifacts

        def logged_artifacts(self):
            return [_Artifact(a, mod.downloads) for a in self._artifacts]

    class Api:
        def runs(self, path):
            mod.paths.append(path)
            return [Run(n, a) for n, a in runs]

    mod.Api = Api
    return mod


def test_download_checkpoint_picks_jax_artifact(tmp_path, monkeypatch):
    runs = [("brisk-sun-6", ["checkpoint_9:v0"]),
            ("calm-sea-7", ["checkpoint_100:v0", "policy_video:v0", "checkpoint_state_491520:v1",
                            "checkpoint_983040:v0", "checkpoint_20000:v3"])]
    picked = {}
    for name, mod in (("jax", jcheckpoint), ("torch", tcheckpoint)):
        stub = _stub_wandb_api(runs)
        monkeypatch.setitem(sys.modules, "wandb", stub)
        out = mod.download_checkpoint("proj", "ent", 7, save_path=str(tmp_path / name))
        assert out == str(tmp_path / name)
        assert stub.paths == ["ent/proj"] and len(stub.downloads) == 1
        picked[name] = stub.downloads[0]
    assert picked["torch"][0] == picked["jax"][0] == "checkpoint_983040:v0"
    # the port's artifact lands in a step directory restore_checkpoint reads
    assert picked["torch"][1] == str(tmp_path / "torch" / "983040")


@pytest.mark.parametrize("runs", [[("other-run-8", ["checkpoint_1:v0"])],
                                  [("calm-sea-7", ["policy_video:v0"])]],
                         ids=["no run", "no checkpoint"])
def test_download_checkpoint_raises_as_jax(tmp_path, monkeypatch, runs):
    messages = []
    for mod in (jcheckpoint, tcheckpoint):
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb_api(runs))
        with pytest.raises(LookupError) as err:
            mod.download_checkpoint("proj", "ent", 7, save_path=str(tmp_path))
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    monkeypatch.setitem(sys.modules, "wandb", None)
    for mod in (jcheckpoint, tcheckpoint):
        with pytest.raises(ImportError):
            mod.download_checkpoint("proj", "ent", 7)


# ---- plotting ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64,), (63,), (50, 3), (51, 4)])
def test_hilbert_transform_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    t = np.arange(shape[0]) * 0.02
    tone = np.sin(2 * np.pi * 2.5 * t).reshape((-1,) + (1,) * (len(shape) - 1))
    data = tone * rng.uniform(0.5, 2.0, shape[1:]) + 0.1 * rng.randn(*shape)
    want = jplotting.hilbert_transform(data, 0.02)
    for x in (data, torch.from_numpy(data)):
        got = tplotting.hilbert_transform(x, 0.02)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert got[1].shape[0] == shape[0] - 1


def test_plot_multi_series_matches_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(3)
    series = {"joint": rng.randn(20, 3), "reward": rng.randn(20)}
    figs = [mod.plot_multi_series(series, 0.02, title="gait", ylabel="rad")
            for mod in (jplotting, tplotting)]
    (jax_ax,), (torch_ax,) = figs[0].axes, figs[1].axes
    assert [ln.get_label() for ln in torch_ax.get_lines()] == [
        ln.get_label() for ln in jax_ax.get_lines()] == ["joint[0]", "joint[1]", "joint[2]",
                                                         "reward"]
    for g, w in zip(torch_ax.get_lines(), jax_ax.get_lines()):
        np.testing.assert_array_equal(g.get_xdata(), w.get_xdata())
        np.testing.assert_array_equal(g.get_ydata(), w.get_ydata())
    for get in ("get_title", "get_xlabel", "get_ylabel"):
        assert getattr(torch_ax, get)() == getattr(jax_ax, get)()
    for fig in figs:
        plt.close(fig)
    for mod in (jplotting, tplotting):  # plotly is not in this image
        with pytest.raises(ImportError):
            mod.plot_multi_series(series, 0.02, backend="plotly")


# ---- profiling -------------------------------------------------------------------


def test_timer_matches_jax(monkeypatch):
    """The same phases under the same fake ``time.perf_counter`` sequence:
    JAX's durations, ``steps_per_sec`` (first call dropped) and summary."""
    clock = [0.0, 0.5, 1.0, 1.25, 2.0, 2.5, 3.0, 3.75, 5.0, 5.5]
    timers = []
    for fence in (jnp.ones(3), torch.ones(3)):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = (jprofiling if isinstance(fence, jax.Array) else tprofiling).Timer()
        for name in ("rollout", "rollout", "sgd", "rollout", "sgd"):
            with timer.phase(name, fence={"x": [fence]} if name == "rollout" else None):
                pass
        timers.append(timer)
        monkeypatch.undo()
    jt, tt = timers
    assert tt.durations == jt.durations
    for name, n in (("rollout", 40), ("sgd", 1), ("missing", 3)):
        assert tt.steps_per_sec(name, n) == jt.steps_per_sec(name, n)
    assert tt.summary() == jt.summary()
    assert tt.durations["rollout"] == [0.5, 0.25, 0.75]


def _ev(start, end, device=DeviceType.CUDA):
    return types.SimpleNamespace(time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=device)


@pytest.mark.parametrize("spans, busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),            # disjoint
    ([(0, 10), (5, 12), (11, 30)], 30.0),  # overlapping chain
    ([(20, 25), (0, 10), (2, 3)], 15.0),   # unsorted, nested
])
def test_device_busy_is_the_union_of_device_intervals(spans, busy):
    """``profiling.device_busy_us`` (``tools/profile_unroll.py`` reads it):
    the union of the device intervals, CPU events left out."""
    events = [_ev(a, b) for a, b in spans] + [_ev(0, 100, DeviceType.CPU)]
    assert tprofiling.device_busy_us(events) == busy


def test_summarize_counts_device_activities():
    """``summarize`` (``tools/profile_unroll.py``'s numbers too): device
    activities by name, busy time as the union of their intervals (overlaps
    counted once), CPU events and ``record_function`` spans left out."""
    def ev(name, start, end, device=DeviceType.CUDA, annotation=False):
        return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev("k3", 0.0, 1000.0), ev("threefry", 500.0, 1500.0), ev("k3", 3000.0, 3500.0),
              ev("aten::add", 0.0, 9000.0, DeviceType.CPU),
              ev("unroll", 0.0, 9000.0, annotation=True)]
    s = tprofiling.summarize(events, window_ms=10.0)
    assert s["launches"] == {"k3": 2, "threefry": 1}
    assert s["device_us"] == {"k3": 1500.0, "threefry": 1000.0}
    assert s["busy_ms"] == 2.0 and s["window_ms"] == 10.0 and s["idle"] == 0.8
    assert tprofiling.device_busy_us(events) == 2000.0


def test_trace_on_the_cpu(tmp_path):
    """``trace`` writes a Chrome trace holding the named span; on the CPU
    its summary has no device activity and the host clock's window."""
    with tprofiling.trace(str(tmp_path), "tiny_block", device="cpu") as tr:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert [os.path.join(tmp_path, f) for f in files] == [tr.path]
    events = json.load(open(tr.path))["traceEvents"]
    assert any(e.get("name") == "tiny_block" for e in events)
    s = tr.summary
    assert s["launches"] == {} and s["busy_ms"] == 0.0 and s["window_ms"] > 0 and s["idle"] == 1.0


# ---- rendering and video --------------------------------------------------------


@pytest.fixture(scope="module")
def mj_model():
    return mujoco.MjModel.from_xml_string(config_xml(EnvConfig()))


def test_render_trajectory_through_a_stub_renderer(mj_model, monkeypatch):
    """Each frame's ``data.qpos`` is the trajectory's row and the camera
    is passed through, for qpos rows, a ``(T, nq)`` array, tensors and
    states; a renderer that cannot open raises ``RuntimeError``."""
    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    rng = np.random.RandomState(0)
    rows = mj_model.qpos0 + 0.01 * rng.randn(5, mj_model.nq)
    states = [types.SimpleNamespace(qpos=torch.from_numpy(r)) for r in rows]
    for traj in (list(rows), rows, torch.from_numpy(rows), states):
        StubRenderer.made.clear()
        frames = tvideo.render_trajectory(mj_model, traj, camera="tracking_cam",
                                          height=12, width=16)
        (r,) = StubRenderer.made
        assert len(frames) == 5 and frames[0].shape == (12, 16, 3)
        np.testing.assert_array_equal(np.stack([q for q, _ in r.seen]), rows)
        assert {c for _, c in r.seen} == {"tracking_cam"}
    monkeypatch.setattr(mujoco, "Renderer", NoGLRenderer)
    with pytest.raises(RuntimeError, match="renderer unavailable"):
        tvideo.render_trajectory(mj_model, rows)


def test_write_video_npz_fallback_equals_jax(tmp_path, no_encoders):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (16, 24, 3), np.uint8) for _ in range(4)]
    outs = [mod.write_video(str(tmp_path / f"{name}_clip.mp4"), frames, fps=25)
            for name, mod in (("jax", jvideo), ("torch", tvideo))]
    assert [os.path.basename(o) for o in outs] == ["jax_clip.npz", "torch_clip.npz"]
    want, got = np.load(outs[0]), np.load(outs[1])
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


# ---- visualize_policy, the slice as a whole ------------------------------------


@pytest.fixture(scope="module")
def rollouts(tmp_path_factory):
    """JAX's ``visualize_policy`` (its env's reset and step jitted on the
    CPU; the states captured through the step function, the render
    stubbed to fail) and the port's (the env on the CPU: K2's plain
    version; mujoco's renderer stubbed to fail) on one policy: a 2 x 16
    elu MLP, its weights and a normalizer carried across."""
    out = tmp_path_factory.mktemp("visualize")
    jenv = JaxEnv(path=None, reward_config=get_config(), action_scale=0.75,
                  observation_history=2)
    nets = jnets.make_ppo_networks(jenv.observation_size, jenv.action_size,
                                   policy_hidden_layer_sizes=(16, 16), activation=jax.nn.elu)
    policy_params = nets.policy_network.init(jax.random.PRNGKey(7))
    rng = np.random.RandomState(0)
    mean = rng.uniform(-0.2, 0.2, jenv.observation_size).astype(np.float32)
    std = rng.uniform(0.5, 1.5, jenv.observation_size).astype(np.float32)
    jnorm = jstats.init_state(jenv.observation_size).replace(mean=jnp.asarray(mean),
                                                             std=jnp.asarray(std))
    jreset, jstep = jax.jit(jenv.reset), jax.jit(jenv.step)
    jstates = []

    def record_step(state, action):
        jstates.append(jax.tree_util.tree_map(np.asarray, state))  # the command it steps under
        new = jstep(state, action)
        jstates.append(jax.tree_util.tree_map(np.asarray, new))
        return new

    def no_gl(*a, **k):
        raise RuntimeError("renderer unavailable")

    jparams = (jnorm, types.SimpleNamespace(policy=policy_params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvideo, "render_trajectory", no_gl)
        jret = jeval.visualize_policy(N_STEPS, jnets.make_inference_fn(nets), jparams, jenv,
                                      record_step, jreset, str(out / "jax"), n_steps=N_STEPS)

    env = PupperV3Env.from_config(EnvConfig(), device="cpu")
    tn = tnets.make_ppo_networks(env.observation_size, env.action_size, (16, 16),
                                 device="cpu")
    tn.policy_network.load_state_dict(
        tnets.params_from_jax(jax.tree_util.tree_map(np.asarray, policy_params)))
    tparams = (tstats.from_jax(mean, std), tn.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mujoco, "Renderer", NoGLRenderer)
        tret = teval.visualize_policy(N_STEPS, tnets.make_inference_fn(tn), tparams, env,
                                      env.step, env.reset, str(out / "torch"), n_steps=N_STEPS)
    traj = np.load(out / "torch" / f"step_{N_STEPS}_policy_trajectory.npz")
    return types.SimpleNamespace(
        jax_states=jstates, jax_ret=jret, torch_ret=tret, traj={k: traj[k] for k in traj.files},
        traj_path=str(out / "torch" / f"step_{N_STEPS}_policy_trajectory.npz"), env=env,
        jax_env=jenv, jax_call=(jnets.make_inference_fn(nets), jparams, jreset, jstep),
        torch_call=(tnets.make_inference_fn(tn), tparams), out=out)


def test_visualize_policy_qpos_matches_jax(rollouts):
    """Each step's qpos within 2e-4 of JAX's (``test_torch_rollout.py``'s
    multi-step tolerance) from the same reset (bit for bit)."""
    qpos = rollouts.traj["qpos"]
    jq = np.stack([s.pipeline_state.qpos for s in rollouts.jax_states[1::2]])
    assert qpos.shape == (N_STEPS + 1, rollouts.env.model.nq) and jq.shape == qpos[1:].shape
    assert np.isfinite(qpos).all()
    np.testing.assert_allclose(qpos[1:], jq, rtol=0, atol=2e-4)
    start = rollouts.jax_states[0].pipeline_state  # the reset's, before the first step
    np.testing.assert_array_equal(qpos[0], np.asarray(start.qpos, np.float32))


def test_visualize_policy_commands_and_file(rollouts):
    """The commands JAX stepped under, the 7-command script; the file's
    dt, render_every, fps (25 at the defaults), camera and MJCF, which
    compiles with mujoco to the env's nq; None where no renderer opens."""
    t = rollouts.traj
    jcmd = np.stack([s.info["command"] for s in rollouts.jax_states[0::2]])
    np.testing.assert_array_equal(t["commands"], jcmd.astype(np.float32))
    script = teval.command_script(0.5, 0.4, 1.5)
    np.testing.assert_array_equal(t["commands"], np.repeat(script, N_STEPS // 7, axis=0))
    assert float(t["dt"]) == rollouts.env.dt == rollouts.jax_env.dt == 0.02
    assert int(t["render_every"]) == 2 and int(t["fps"]) == 25
    assert str(t["camera"]) == "tracking_cam"
    assert str(t["mjcf"]) == config_xml(EnvConfig())
    assert mujoco.MjModel.from_xml_string(str(t["mjcf"])).nq == rollouts.env.model.nq
    assert rollouts.torch_ret is None and rollouts.jax_ret is None


def test_visualize_policy_renders_and_logs_as_jax(rollouts, monkeypatch, no_encoders):
    """Where a renderer opens (the stub): the video through ``write_video``
    (its ``.npz`` fallback here) and the same four records logged as JAX's
    ``visualize_policy`` logs; one step of each rollout."""
    frames = []

    def jax_render(mj_model, trajectory, camera=None):
        frames.append((len(trajectory), camera))
        return [np.zeros((8, 8, 3), np.uint8) for _ in trajectory]

    class Log:
        def __init__(self):
            self.calls = []

        def log(self, metrics, step):
            self.calls.append((dict(metrics), step))

    make_policy, jparams, jreset, jstep = rollouts.jax_call
    jlog, tlog = Log(), Log()
    monkeypatch.setattr(jvideo, "render_trajectory", jax_render)
    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    jpath = jeval.visualize_policy(3, make_policy, jparams, rollouts.jax_env, jstep, jreset,
                                   str(rollouts.out / "jax1"), n_steps=1, logger=jlog)
    tmake, tparams = rollouts.torch_call
    env = rollouts.env
    StubRenderer.made.clear()
    tpath = teval.visualize_policy(3, tmake, tparams, env, env.step, env.reset,
                                   str(rollouts.out / "torch1"), n_steps=1, logger=tlog)
    assert os.path.basename(tpath) == os.path.basename(jpath) == "step_3_policy.npz"
    assert len(np.load(tpath)["frames"]) == frames[0][0] == 1  # qpos rows 0 of 2, every 2nd
    assert StubRenderer.made[0].seen[0][1] == frames[0][1] == "tracking_cam"
    for calls in (jlog.calls, tlog.calls):
        calls[0][0]["eval/video_path"] = os.path.basename(calls[0][0]["eval/video_path"])
    assert tlog.calls == jlog.calls and len(tlog.calls[0][0]) == 4


def test_video_cli_renders_a_recorded_trajectory(rollouts, monkeypatch, no_encoders, capsys):
    """``python -m puppax_torch.tools.video <file>`` (``main`` in process):
    the file's MJCF compiled, every 2nd qpos row rendered from its camera,
    written beside it as ``step_<N>_policy`` (the ``.npz`` fallback)."""
    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    StubRenderer.made.clear()
    tvideo.main([rollouts.traj_path])
    out = capsys.readouterr().out.strip()
    assert out == os.path.join(os.path.dirname(rollouts.traj_path), f"step_{N_STEPS}_policy.npz")
    (r,) = StubRenderer.made
    qpos = rollouts.traj["qpos"]
    np.testing.assert_allclose(np.stack([q for q, _ in r.seen]), qpos[::2], rtol=0, atol=0)
    assert {c for _, c in r.seen} == {"tracking_cam"}
    with np.load(out) as f:
        assert f["frames"].shape[0] == len(qpos[::2]) == 8 and int(f["fps"]) == 25


def test_tools_import_without_optional_packages():
    """``puppax_torch.tools.eval`` (and every ported tool) imports with
    mujoco, wandb, plotly, mediapy, matplotlib, jax and puppax unavailable."""
    import subprocess

    code = (
        "import sys\n"
        "for m in ('mujoco', 'wandb', 'plotly', 'mediapy', 'matplotlib', 'jax', 'puppax'):\n"
        "    sys.modules[m] = None\n"
        "import puppax_torch.tools.eval, puppax_torch.tools.video, puppax_torch.tools.plotting\n"
        "import puppax_torch.tools.profiling, puppax_torch.tools.metrics\n"
        "import puppax_torch.train.checkpoint\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
