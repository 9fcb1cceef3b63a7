"""The K3, K2, K1 and K4 kernels on an NVIDIA GPU against their plain
versions (as the team kernels, and as the one-thread kernels beside
them), short training runs through them, and the kernel-time
probes' kernels (``puppax_torch/probes``) against their plain versions.

These tests need a CUDA device and nvcc; without them they skip. On the
GPU host (which has no JAX) run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax_torch import random
from puppax_torch.env import fused_unroll, soa_env
from puppax_torch.kernels import build
from puppax_torch.physics import soa

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU host with "
                    "`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda`")
    return H.torch_env(n_substeps=5, device="cuda")


def _blocks(env, B, seed):
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = H.wrapped_step_blocks(s, es, env.model, dr, np.random.RandomState(seed), n=B,
                                   episode_length=1000)
    return [b.cuda() for b in H.to_torch(blocks)]


@pytest.mark.parametrize("B", [256, 300])
def test_kernel_matches_plain(env, B):
    """Team K3 (``soa_env.wrapped_step``) on full and ragged last 32-env
    groups of random states: within tolerance of its plain version, and bit
    for bit with the one-thread K3 (``wrapped_step_one_thread``); one
    counted launch of each."""
    from puppax_torch.probes import common

    s, es = env._s, env._es
    blocks = _blocks(env, B, seed=B)
    before = (soa_env.wrapped_step.launches, soa_env.wrapped_step_one_thread.launches)
    got = soa_env.wrapped_step(s, es, 5, 1000, *blocks)
    one = soa_env.wrapped_step_one_thread(s, es, 5, 1000, *blocks)
    torch.cuda.synchronize()
    assert (soa_env.wrapped_step.launches, soa_env.wrapped_step_one_thread.launches) == (
        before[0] + 1, before[1] + 1)
    assert common.compare_exact(got, one) == (0.0, 0)
    want = soa_env.wrapped_step_rows(s, es, 5, 1000, *blocks)
    H.assert_wrapped_outputs_close(
        [g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want], s, es,
        soa_env.aux_row_map(es), f"team K3 vs plain at B={B}",
    )


def test_wrapper_refuses_bad_blocks(env):
    s, es = env._s, env._es
    blocks = _blocks(env, 128, seed=1)
    mixed = list(blocks)
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError):
        soa_env.wrapped_step(s, es, 5, 1000, *mixed)
    strided = list(blocks)
    strided[0] = blocks[0].t().contiguous().t()
    with pytest.raises(ValueError):
        soa_env.wrapped_step(s, es, 5, 1000, *strided)


def test_env_step_kernel_matches_plain(env):
    """K2 at the evaluator's 128 envs on random states (the nominal model's
    parameter rows broadcast, as in the eval env)."""
    s, es = env._s, env._es
    dr = env.dr_rows(128).cpu().numpy()
    blocks = H.env_step_blocks(s, es, env.model, dr, np.random.RandomState(128), n=128)
    blocks = [b.cuda() for b in H.to_torch(blocks)]
    before = soa_env.env_step.launches
    got = soa_env.env_step(s, es, 5, *blocks)
    torch.cuda.synchronize()
    assert soa_env.env_step.launches == before + 1
    want = soa_env.env_step_rows(s, es, 5, *blocks)
    H.assert_env_outputs_close([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
                               s, es, "K2 vs plain at B=128")


@pytest.mark.parametrize("B", [4096, 4097])
def test_team_k1_bit_for_bit(env, B):
    """Team K1 (``soa.step_batched``) at the training width and with a
    ragged last group of 32 envs, bit for bit with its plain version and
    with the one-thread K1."""
    s = env._s
    dr = env.dr_rows(B).cpu().numpy()
    blocks = [b.cuda() for b in H.to_torch(
        H.physics_step_blocks(env.model, dr, np.random.RandomState(B), n=B))]
    before = (soa.step_batched.launches, soa.step_batched_one_thread.launches)
    got = soa.step_batched(s, *blocks, 5)
    one = soa.step_batched_one_thread(s, *blocks, 5)
    torch.cuda.synchronize()
    assert (soa.step_batched.launches, soa.step_batched_one_thread.launches) == (
        before[0] + 1, before[1] + 1)
    want = soa.physics_step_rows(s, 5, *blocks)
    for g, o, w in zip(got, one, want):
        assert torch.equal(g, w) and torch.equal(o, w)


@pytest.mark.parametrize("B", [128, 4096])
def test_team_k2_bit_for_bit(env, B):
    """Team K2 (``soa_env.env_step``) at the evaluator's and the training
    width, bit for bit with its plain version and with the one-thread K2."""
    s, es = env._s, env._es
    dr = env.dr_rows(B).cpu().numpy()
    blocks = [b.cuda() for b in H.to_torch(
        H.env_step_blocks(s, es, env.model, dr, np.random.RandomState(B), n=B))]
    before = (soa_env.env_step.launches, soa_env.env_step_one_thread.launches)
    got = soa_env.env_step(s, es, 5, *blocks)
    one = soa_env.env_step_one_thread(s, es, 5, *blocks)
    torch.cuda.synchronize()
    assert (soa_env.env_step.launches, soa_env.env_step_one_thread.launches) == (
        before[0] + 1, before[1] + 1)
    want = soa_env.env_step_rows(s, es, 5, *blocks)
    for g, o, w in zip(got, one, want):
        assert torch.equal(g, w) and torch.equal(o, w)


def test_short_training_launches_both_kernels(env, tmp_path):
    """One training step (4 unroll steps of 256 envs) and two evaluations of
    16 envs: 4 team K3 launches and 2 x 1000 team K2 launches, none of the
    one-thread kernels."""
    from puppax_torch.train import networks, ppo

    def factory(obs, act, device=None, key=None):
        return networks.make_ppo_networks(obs, act, (32, 32), (32, 32), device=device, key=key)

    soa_env.wrapped_step.launches = soa_env.env_step.launches = 0
    soa_env.wrapped_step_one_thread.launches = soa_env.env_step_one_thread.launches = 0
    _, (norm, _), metrics = ppo.train(
        env, num_timesteps=64 * 4 * 4, episode_length=1000, num_envs=256, num_eval_envs=16,
        unroll_length=4, batch_size=64, num_minibatches=4, num_updates_per_batch=1,
        num_evals=2, network_factory=factory, device="cuda", checkpoint_dir=str(tmp_path),
    )
    assert (soa_env.wrapped_step.launches, soa_env.env_step.launches) == (4, 2000)
    # K3's and K2's launches are the team kernels': the one-thread kernels are
    # not on the path
    assert (soa_env.wrapped_step_one_thread.launches, soa_env.env_step_one_thread.launches) == (
        0, 0)
    assert "wrapped_step_team" in build.last_build and "env_step_team" in build.last_build
    assert float(norm.count) == 4 * 256
    assert np.isfinite(metrics["training/total_loss"])
    assert 0 < metrics["eval/avg_episode_length"] <= 1000


@pytest.mark.parametrize("B", [256, 300])
def test_physics_step_kernel_matches_plain(env, B):
    """K1 on random states (full and ragged last block), and
    ``make_batched_step``'s routing on the card: float32 to K1, float64 to
    the torch pipeline."""
    s = env._s
    dr = env.dr_rows(B).cpu().numpy()
    blocks = [b.cuda() for b in H.to_torch(
        H.physics_step_blocks(env.model, dr, np.random.RandomState(B), n=B))]
    before = soa.step_batched.launches
    got = soa.step_batched(s, *blocks, 5)
    torch.cuda.synchronize()
    assert soa.step_batched.launches == before + 1
    want = soa.physics_step_rows(s, 5, *blocks)
    H.assert_physics_outputs_close([g.cpu().numpy() for g in got],
                                   [w.cpu().numpy() for w in want], s, f"K1 vs plain at B={B}")
    q, v, c = (b.t() for b in blocks[:3])
    out = env._cv_step(env.model, q, v, c)
    assert soa.step_batched.launches == before + 2
    assert torch.equal(out[0], got[0].t())
    out64 = env._cv_step(env.model, q.double(), v.double(), c.double())
    assert soa.step_batched.launches == before + 2 and out64[0].dtype == torch.float64


def test_physics_only_training_launches_k1(tmp_path, monkeypatch):
    """PUPPAX_SOA_ENV=off: one training step (4 unroll steps of 256 envs)
    and two evaluations of 16 envs launch K1 4 + 2 x 1000 times, K2 and K3
    never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.train import networks, ppo

    monkeypatch.setenv("PUPPAX_SOA_ENV", "off")
    env = H.torch_env(n_substeps=5, device="cuda")

    def factory(obs, act, device=None, key=None):
        return networks.make_ppo_networks(obs, act, (32, 32), (32, 32), device=device, key=key)

    soa_env.wrapped_step.launches = soa_env.env_step.launches = soa.step_batched.launches = 0
    soa.step_batched_one_thread.launches = 0
    _, (norm, _), metrics = ppo.train(
        env, num_timesteps=64 * 4 * 4, episode_length=1000, num_envs=256, num_eval_envs=16,
        unroll_length=4, batch_size=64, num_minibatches=4, num_updates_per_batch=1,
        num_evals=2, network_factory=factory, device="cuda", checkpoint_dir=str(tmp_path),
    )
    assert (soa_env.wrapped_step.launches, soa_env.env_step.launches) == (0, 0)
    assert soa.step_batched.launches == 4 + 2000
    # K1's launches are the team kernel's: the one-thread K1 is not on the path
    assert soa.step_batched_one_thread.launches == 0 and "physics_step_team" in build.last_build
    assert float(norm.count) == 4 * 256
    assert np.isfinite(metrics["training/total_loss"])


@pytest.mark.parametrize("B,gait,activation", [(256, False, "elu"), (300, True, "tanh")])
def test_fused_unroll_kernel_matches_plain(B, gait, activation):
    """K4 over T=3 (full and ragged last block; the clock off and on; every
    env ends an episode inside the unroll) against its plain version: the
    final carry and each step's aux rows at K3's tolerances, the policy
    outputs at 1e-5 (bit for bit expected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.env.pupper import PupperV3Env

    T, L = 3, 4
    env = PupperV3Env(device="cuda", gait_phase_observation=gait, **H.env_kwargs(5))
    s, es = env._s, env._es
    layers, blocks = H.fused_unroll_inputs(env, B, T, activation, L)
    before = fused_unroll.unroll.launches
    got = fused_unroll.unroll(s, es, 5, L, activation, layers, *blocks)
    torch.cuda.synchronize()
    assert fused_unroll.unroll.launches == before + 1
    want = fused_unroll.unroll_rows(s, es, 5, L, activation, layers, *blocks)
    cpu = lambda xs: [x.cpu().numpy() for x in xs]  # noqa: E731
    for t in range(T):
        H.assert_wrapped_outputs_close(cpu(got[:4] + (got[9][t],)), cpu(want[:4] + (want[9][t],)),
                                       s, es, soa_env.aux_row_map(es), f"K4 vs plain, step {t}")
    for i in (5, 6, 7):
        np.testing.assert_allclose(got[i].cpu().numpy(), want[i].cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(got[8].cpu().numpy(), want[8].cpu().numpy(), atol=2e-4)
    if gait:
        np.testing.assert_allclose(got[4].cpu().numpy(), want[4].cpu().numpy(), atol=1e-6)


@pytest.mark.parametrize("B,gait,activation", [(4096, False, "elu"), (130, True, "softmax")])
def test_team_k4_bit_for_bit(B, gait, activation):
    """Team K4 (``fused_unroll.unroll``) over T=3, every env ending an
    episode inside the unroll, bit for bit with the one-thread K4
    (``unroll_one_thread``) and with ``unroll_rows``; one counted launch
    of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.probes import common

    T, L = 3, 4
    env = PupperV3Env(device="cuda", gait_phase_observation=gait, **H.env_kwargs(5))
    s, es = env._s, env._es
    layers, blocks = H.fused_unroll_inputs(env, B, T, activation, L)
    before = (fused_unroll.unroll.launches, fused_unroll.unroll_one_thread.launches)
    got = fused_unroll.unroll(s, es, 5, L, activation, layers, *blocks)
    one = fused_unroll.unroll_one_thread(s, es, 5, L, activation, layers, *blocks)
    torch.cuda.synchronize()
    assert (fused_unroll.unroll.launches, fused_unroll.unroll_one_thread.launches) == (
        before[0] + 1, before[1] + 1)
    want = fused_unroll.unroll_rows(s, es, 5, L, activation, layers, *blocks)
    flat = lambda xs: [x.reshape(-1, B) for x in xs if x is not None]  # noqa: E731
    assert common.compare_exact(flat(got), flat(want)) == (0.0, 0)
    assert common.compare_exact(flat(one), flat(want)) == (0.0, 0)


@pytest.mark.parametrize("cut", ["fk", "smooth", None])
def test_probe_physics_kernel_matches_plain(env, cut):
    """K1's probe build (cut after ``cut``; None: the whole body) on random
    states at 256 envs against the plain version with the cut and the sink
    row, bit for bit, in both layouts and at 32 and 128 threads per block."""
    from puppax_torch.probes import common

    s, B = env._s, 256
    dr = env.dr_rows(B).cpu().numpy()
    blocks = [b.cuda() for b in H.to_torch(
        H.physics_step_blocks(env.model, dr, np.random.RandomState(7), n=B))]
    want = soa.physics_step_rows(s, 5, *blocks, phase_limit=cut, sink=True)
    name = common.k1_probe_name(cut)
    before = common.launches[name]
    for layout in (common.ROW_MAJOR, common.BLOCK_MAJOR):
        ins = blocks if layout == common.ROW_MAJOR else [common.to_block_major(x) for x in blocks]
        for threads in (32, 128):
            outs = common.empty_outputs(s, B, "cuda", layout)
            common.physics_probe(s, 5, ins, outs, cut, layout, threads)
            torch.cuda.synchronize()
            got = outs if layout == common.ROW_MAJOR else [common.from_block_major(x)
                                                          for x in outs]
            assert common.compare_exact(got, want) == (0.0, 0), (cut, layout, threads)
    assert common.launches[name] == before + 2


TEAM_PROBE_CUTS = ("fk", "efc", None)


@pytest.fixture(scope="module")
def team_probes(env):
    """Team K1's probe builds of ``TEAM_PROBE_CUTS``, built at once."""
    build.build_in_parallel(*[(lambda cut=cut: build.probe_physics_team_library(env._s, 5, cut))
                              for cut in TEAM_PROBE_CUTS])
    return env


@pytest.mark.parametrize("cut", ["fk", "efc"])
def test_team_probe_physics_kernel_matches_plain(team_probes, cut):
    """Team K1's probe build (its program cut after ``cut``, 4 warps) on
    random states against the plain version with the cut and the sink row,
    bit for bit: at 256 envs row-major and block-major (32-env tiles), and
    at a ragged 300 row-major; one counted launch each."""
    from puppax_torch.probes import common

    env = team_probes
    s = env._s
    for B, layouts in ((256, (common.ROW_MAJOR, common.BLOCK_MAJOR)), (300, (common.ROW_MAJOR,))):
        dr = env.dr_rows(B).cpu().numpy()
        blocks = [b.cuda() for b in H.to_torch(
            H.physics_step_blocks(env.model, dr, np.random.RandomState(B + 1), n=B))]
        want = soa.physics_step_rows(s, 5, *blocks, phase_limit=cut, sink=True)
        for layout in layouts:
            name = common.k1_probe_name(cut, layout, team=True)
            before = common.launches[name]
            ins = blocks if layout == common.ROW_MAJOR else [
                common.to_block_major(x, common.TEAM_TILE) for x in blocks]
            outs = common.empty_outputs(s, B, "cuda", layout, common.TEAM_TILE)
            common.physics_probe_team(s, 5, ins, outs, cut, layout)
            torch.cuda.synchronize()
            got = outs if layout == common.ROW_MAJOR else [common.from_block_major(x)
                                                          for x in outs]
            assert common.compare_exact(got, want) == (0.0, 0), (cut, B, layout)
            assert common.launches[name] == before + 1


def test_team_full_cut_equals_team_k1(team_probes):
    """The team full cut (sink row 0) at 4096 envs and a ragged 1000 equals
    the production team K1 (``soa.step_batched``) and the plain version bit
    for bit."""
    from puppax_torch.probes import common

    env = team_probes
    s = env._s
    for B in (4096, 1000):
        dr = env.dr_rows(B).cpu().numpy()
        blocks = [b.cuda() for b in H.to_torch(
            H.physics_step_blocks(env.model, dr, np.random.RandomState(B + 2), n=B))]
        outs = common.empty_outputs(s, B, "cuda")
        common.physics_probe_team(s, 5, blocks, outs)
        prod = soa.step_batched(s, *blocks, 5)
        torch.cuda.synchronize()
        assert common.compare_exact(outs[:3], prod) == (0.0, 0), B
        assert common.compare_exact(outs[:3], soa.physics_step_rows(s, 5, *blocks)) == (0.0, 0)
        assert torch.equal(outs[3], torch.zeros_like(outs[3]))


@pytest.mark.parametrize("fmad", [False, True])
def test_fma_chain_kernel_against_plain(fmad):
    """The chain at K = 64 on both probe grids: the ``--fmad=false`` build
    equals the torch loop bit for bit; the contracted one stays finite and
    within 1e-5 of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import probe_fma_fusion as F

    dev = torch.device("cuda", 0)
    for blocks, n in (F.TPU_GRID, F.latency_grid(dev)):
        a, b = F.chain_inputs(n, dev)
        for mode in F.MODES:
            out = torch.empty((blocks, n), dtype=torch.float32, device=dev)
            F.fma_chain(a, b, out, 64, mode, blocks, fmad)
            want = F.chain_rows(a, b, 64, mode, blocks)
            if fmad:
                assert torch.isfinite(out).all()
                torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
            else:
                assert torch.equal(out, want), (blocks, mode)


def test_add_one_kernel_and_graph_replay():
    """``x + 1`` on the card equals the plain version; a captured graph of
    the kernel replays it without counting a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common
    from puppax_torch.probes import probe_launch_overhead as P

    x = torch.randn((32, 8, 128), device="cuda")
    y = torch.empty_like(x)
    before = common.launches["add_one"]
    P.add_one(x, y)
    torch.cuda.synchronize()
    assert torch.equal(y, x + 1) and common.launches["add_one"] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        P.add_one(y, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, y + 1) and common.launches["add_one"] == before + 1
    eager, graphed = common.carried_us(P.add_one, (x,), iters=4, runs=2)
    assert eager > 0 and graphed > 0 and common.launches["add_one"] == before + 1 + 4 * 2 + 4 * 2


@pytest.mark.parametrize("nb", [4, 32, "ragged"])
def test_add_one_redesign_and_one_element_bit_for_bit(nb):
    """The redesign (with and without PDL) and ``add_one[one-element]``
    against ``x + 1`` at nb = 4 and 32 and a ragged, misaligned n (``check``
    raises on one differing element), then a carried chain of 50 of each
    captured as one CUDA graph: the PDL chain's graph holds 49
    programmatic edges, and both replays equal 50 torch adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common
    from puppax_torch.probes import probe_launch_overhead as P

    if nb == 4:
        res = P.check(torch.device("cuda", 0))
        assert all(d == 0 for r in res.values() for _, d in r.values()) and len(res) == 4
    n = P.RAGGED if nb == "ragged" else 8 * nb * 8 * 128
    x = torch.randn(n, device="cuda")
    before = dict(common.launches)
    res = P.graph_chain(x, 50)
    assert (res["edges"], res["programmatic"], res["differing"]) == (49, 49, 0)
    assert common.launches["add_one"] == before.get("add_one", 0) + 50
    c = common.Carry(P.add_one_one_element, (x,), 50)
    graph, per_replay = common.capture_graph(c.window)
    c.reset()
    graph.replay()
    want = x.clone()
    for _ in range(50):
        want = want + 1
    assert torch.equal(c.sets[0][0], want) and per_replay == {P.ONE_ELEMENT: 50}


def test_export_on_the_card(tmp_path):
    """A policy on the card exported through the CLI (``--device cuda``)
    and replayed by the native runtime: within 1e-5 / 1e-6 of the JSON's
    replay and within 1e-4 / 1e-5 of the card's deterministic policy
    (TF32 off), the gait clock's ticks too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dataclasses import replace as dc_replace

    from puppax_torch.configs import EnvConfig
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.export import apply_exported_policy, convert_params
    from puppax_torch.export.native import NativePolicy
    from puppax_torch.scripts import export_policy
    from puppax_torch.train import checkpoint, networks, ppo, running_statistics

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for gait in (False, True):
        env = PupperV3Env.from_config(dc_replace(EnvConfig(), gait_phase_observation=gait),
                                      device="cuda")
        nets = networks.make_ppo_networks(env.observation_size, env.action_size, (128,) * 4,
                                          (32,), "elu", device="cuda",
                                          key=random.key(int(gait), "cuda"))
        obs = torch.randn((64, env.observation_size), generator=g, device="cuda") * 2.0 + 0.3
        norm = running_statistics.update(running_statistics.init_state(env.observation_size,
                                                                       device="cuda"), obs)
        ckpt = tmp_path / f"ckpt{int(gait)}"
        checkpoint.save_checkpoint(7, ppo.params_state_dict((norm, nets.params)), ckpt)
        out = tmp_path / f"policy{int(gait)}.json"
        exported = export_policy.main(["--checkpoint", str(ckpt), "--out", str(out),
                                       "--device", "cuda"]
                                      + (["--gait-phase-observation"] if gait else []))
        assert exported == convert_params(
            (norm, nets.policy_network), "elu", 0.75, 5.0, 0.25, env._default_pose, env.uppers,
            env.lowers, True, 2, 0.0, 0.0, gait_phase_observation=gait, gait_frequency=2.5,
            control_dt=0.02)
        policy = NativePolicy(str(out))
        with torch.no_grad():
            card = nets.action_distribution.mode(
                nets.policy_network(running_statistics.normalize(obs, norm))).cpu().numpy()
        raw = obs.cpu().numpy()
        if gait:
            policy.reset_clock()
        for i in range(8):
            if gait:
                phase = (2.0 * np.pi * 2.5 * 0.02 * i) % (2.0 * np.pi)
                full = np.concatenate([raw[i, :-2], [np.cos(phase), np.sin(phase)]]).astype(
                    np.float32)
                got = policy.infer_clocked(raw[i, :-2])
                with torch.no_grad():
                    x = torch.from_numpy(full).cuda()
                    want = nets.action_distribution.mode(
                        nets.policy_network(running_statistics.normalize(x, norm))).cpu().numpy()
            else:
                full, got, want = raw[i], policy(raw[i]), card[i]
            np.testing.assert_allclose(got, apply_exported_policy(exported, full), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        policy.close()


def test_short_training_on_the_fused_lane(env, tmp_path, monkeypatch):
    """PUPPAX_FUSED_UNROLL=on: one training step (one 4-step unroll of 256
    envs) and two evaluations of 16 envs launch K4 once, K3 never and K2
    2 x 1000 times."""
    from puppax_torch.train import networks, ppo

    monkeypatch.setenv("PUPPAX_FUSED_UNROLL", "on")

    def factory(obs, act, device=None, key=None):
        return networks.make_ppo_networks(obs, act, (32, 32), (32, 32), device=device, key=key)

    soa_env.wrapped_step.launches = soa_env.env_step.launches = fused_unroll.unroll.launches = 0
    _, (norm, _), metrics = ppo.train(
        env, num_timesteps=64 * 4 * 4, episode_length=1000, num_envs=256, num_eval_envs=16,
        unroll_length=4, batch_size=64, num_minibatches=4, num_updates_per_batch=1,
        num_evals=2, network_factory=factory, device="cuda", checkpoint_dir=str(tmp_path),
    )
    assert fused_unroll.unroll.launches == 1
    assert (soa_env.wrapped_step.launches, soa_env.env_step.launches) == (0, 2000)
    assert float(norm.count) == 4 * 256
    assert np.isfinite(metrics["training/total_loss"])


@pytest.mark.parametrize("mode", ["q", "min", "full"])
def test_copy_kernel_matches_plain_and_replays(mode):
    """The overhead probes' copy at 4096, 128 and 300 envs equals its plain
    version bit for bit, one counted launch each; a CUDA graph of it
    replays the same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common

    g = torch.Generator(device="cuda").manual_seed(0)
    blocks = [torch.randn((n, 4096), generator=g, device="cuda") for n in (19, 18, 12, 166)]
    blocks = blocks[: {"q": 1, "min": 2, "full": 4}[mode]]
    for B in (4096, 128, 300):
        ins = [x[:, :B].contiguous() for x in blocks]
        before = common.launches[common.copy_name(mode, B)]
        assert common.check_copy(mode, ins, 351)[:2] == (0.0, 0), B
        assert common.launches[common.copy_name(mode, B)] == before + 1
    outs = common.copy_outputs(mode, blocks, 351)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        common.copy_probe(mode, blocks, outs)
    for o in outs:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    want = common.copy_outputs(mode, blocks, 351)
    common.copy_rows(mode, blocks, want)
    assert common.compare_exact(outs, want) == (0.0, 0)


@pytest.mark.parametrize("B,offset", [(4096, 1), (130, 0)], ids=["4096-offset", "130"])
@pytest.mark.parametrize("mode", ["q", "min", "full"])
def test_copy_scalar_path_matches_plain(mode, B, offset):
    """The element-parallel copy on blocks offset by one float (no 16-byte
    alignment) and at 130 envs (counts that are no multiple of 4): its
    scalar path, and the one-thread copy, bit for bit with the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common

    g = torch.Generator(device="cuda").manual_seed(1)
    blocks = []
    for n in (19, 18, 12, 166)[: {"q": 1, "min": 2, "full": 4}[mode]]:
        buf = torch.empty(n * B + offset, device="cuda")
        blocks.append(buf[offset:].view(n, B))
        blocks[-1].copy_(torch.randn((n, B), generator=g, device="cuda"))
    assert common.check_copy(mode, blocks, 351)[:2] == (0.0, 0)


def test_boundary_variants_agree_on_the_card(env):
    """Three steps of K1 on rows-resident carries, behind transposes and
    through the physics-only lane's splice agree bit for bit at 256 envs."""
    from puppax_torch.probes import profile_boundary as P

    from puppax_torch.probes import common

    s, B = env._cv_step.s, 256
    dr = env.dr_rows(B)
    q, v, ctrl = [b.cuda() for b in H.to_torch(
        H.physics_step_blocks(env.model, dr.cpu().numpy(), np.random.RandomState(9), n=B)[:3])]
    want = P.window(P.rows_resident(s, 5, ctrl, dr), (q, v), 3)
    for step in (P.transpose_bound(s, 5, ctrl, dr), P.splice(env, ctrl.t().contiguous(), dr)):
        got = P.window(step, (q.t().contiguous(), v.t().contiguous()), 3)
        assert common.compare_exact([x.t() for x in got], want) == (0.0, 0)


def test_graphed_k3_unroll_equals_eager(env):
    """The K3 lane's T=20 unroll captured as one CUDA graph gives the eager
    unroll's outputs bit for bit (``profile_scan.unroll_ab``)."""
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.probes import profile_scan
    from puppax_torch.train import networks, running_statistics

    key_net, key_env, key = random.split(random.key(3, "cuda"), 3).unbind(0)
    wrapped = wrap_for_training(env, 1000)
    lane = FastLane(wrapped)
    policy = networks.make_ppo_networks(env.observation_size, env.action_size, (32, 32),
                                        (32, 32), device="cuda", key=key_net).policy_network
    params = (running_statistics.init_state(env.observation_size, device="cuda"), policy)
    state = wrapped.reset(random.split(key_env, 256))
    ab = profile_scan.unroll_ab(lane, state, params, *profile_scan.lane_draws(lane, state, key),
                                runs=1)
    assert ab["differing"] == [] and ab["T"] == 20 and ab["graph_ms"] > 0


@pytest.mark.parametrize("B", [4096, 128])
def test_soa_substep_kernel_matches_plain(B):
    """The synthetic SoA substep (60 rounds) on the TPU probe's input recipe
    equals its plain version bit for bit, one counted launch; 100 chained
    substeps stay finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common
    from puppax_torch.probes import pallas_soa_probe as P

    q, v = P.soa_inputs(B, seed=0, device="cuda")
    before = common.launches["soa_substep"]
    res = P.check(q, v)
    assert (res["max_abs_err"], res["differing"]) == (0.0, 0)
    assert common.launches["soa_substep"] == before + 1
    carry = common.Carry(lambda a, b: P.soa_substep(a, v, b), (q,), 100)
    carry.reset()
    carry.window()
    assert torch.isfinite(carry.sets[0][0]).all()


@pytest.mark.parametrize("B", [4096, 128, 300])
def test_team_soa_substep_kernel_matches_plain(B):
    """Team P12 (``TEAM_WARPS`` warps) equals its plain version and the
    one-thread P12 bit for bit, also on a ragged last 32-env group, one
    counted launch; 100 chained substeps from a CUDA graph stay finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common
    from puppax_torch.probes import pallas_soa_probe as P

    q, v = P.soa_inputs(B, seed=1, device="cuda")
    before = common.launches["soa_substep_team"]
    res = P.check(q, v, team=True)
    assert (res["max_abs_err"], res["differing"], res["one_thread_differing"]) == (0.0, 0, 0)
    assert common.launches["soa_substep_team"] == before + 1
    carry = common.Carry(lambda a, b: P.soa_substep(a, v, b, team=True), (q,), 100)
    common.eager_and_graph_ms(carry.window, 1, carry.reset)
    assert torch.isfinite(carry.sets[0][0]).all()


def test_fma_chain_redesign_matches_one_element():
    """The chain's redesign on the TPU's grid at K = 64: under
    ``--fmad=false`` bit for bit with the plain loop and the one-element
    kernel; under ``--fmad=true`` finite, within 1e-5 of the plain loop, and
    bit for bit with the one-element kernel in add2k and mul2k (no pairs)
    and in muladd where both builds' SASS shows every pair as one FFMA; its
    grid at most the resident blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import probe_fma_fusion as F

    dev = torch.device("cuda", 0)
    blocks, n = F.TPU_GRID
    a, b = F.chain_inputs(n, dev)
    build.build_in_parallel(*[(lambda f=f, lib=lib: lib(f)) for f in (False, True)
                              for lib in (build.fma_chain_library, build.fma_chain_ilp_library)])
    contracted = all(F.contracts_every_pair(F._sass_report(True, d))
                     for d in ("one-element", "redesign"))
    for mode in F.MODES:
        want = F.chain_rows(a, b, 64, mode, blocks)
        for fmad in (False, True):
            got, one = (torch.empty((blocks, n), device=dev) for _ in range(2))
            F.fma_chain(a, b, got, 64, mode, blocks, fmad)
            F.fma_chain_one_element(a, b, one, 64, mode, blocks, fmad)
            if fmad:
                assert torch.isfinite(got).all()
                torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
                if mode != "muladd" or contracted:
                    assert torch.equal(got, one), mode
            else:
                assert torch.equal(got, want) and torch.equal(one, want), mode
    lib = build.fma_chain_ilp_library(False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = lib.fma_chain_occupancy(1, F.ILP_THREADS)
    assert 0 < lib.fma_chain_ilp_grid(n, blocks) <= sms * per_sm


def test_team_k1_fmad_probe_moves_within_tolerance(env):
    """Team K1's program under ``--fmad=true`` against ``--fmad=false`` on
    the probe's 4096 nominal DR'd states: finite outputs, at most
    ``MAX_OUTSIDE_ENVS`` envs outside qpos 5e-5 / scaled qvel 5e-4
    (``k1_fmad_outputs`` raises otherwise), one counted launch of
    ``k1_team_probe_full_fmad``."""
    from puppax_torch.probes import common
    from puppax_torch.probes import probe_fma_fusion as F

    s = env._s
    blocks = common.nominal_blocks(s, env.model, 4096, "cuda")
    build.build_in_parallel(*[(lambda f=f: build.probe_physics_team_library(s, 5, None, fmad=f))
                              for f in (False, True)])
    before = common.launches["k1_team_probe_full_fmad"]
    _, moved = F.k1_fmad_outputs(s, 5, blocks, team=True)
    assert moved["outside"] <= F.MAX_OUTSIDE_ENVS
    assert common.launches["k1_team_probe_full_fmad"] == before + 1


@pytest.mark.parametrize("B", [4096, 128, 300])
def test_spd_solve_kernel_matches_plain_and_cusolver(B):
    """The batched 18 x 18 SPD solve on the TPU probe's systems, one warp
    per env (``spd_solve``) and one thread per env (``spd_solve_one_thread``),
    equals its plain version (``linalg.spd_solve``) bit for bit, one counted
    launch each, and agrees with cholesky_ex + cholesky_solve within 1e-4
    of max|x|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common
    from puppax_torch.probes import pallas_spd_poc as S

    A, b = (torch.from_numpy(x).cuda() for x in S.spd_inputs(B))
    A_t, b_t = S.to_lanes(A, b)
    before = common.launches["spd_solve"], common.launches["spd_solve[one-thread]"]
    res = S.check(A_t, b_t)
    assert res["differing"] == 0 and res["one_thread"]["differing"] == 0
    assert (common.launches["spd_solve"], common.launches["spd_solve[one-thread]"]) == (
        before[0] + 1, before[1] + 1)
    x = torch.empty_like(b_t)
    S.spd_solve(A_t, b_t, x)
    with S.cusolver_backend():
        lib, info = S.library_solve(A, b)
    assert not info.any()
    lib = lib.t()
    assert float((lib - x).abs().max()) < S.LIBRARY_TOL * float(x.abs().max())


@pytest.mark.parametrize("B", [4096, 130, 300])
def test_spd_solve_warp_kernel_at_every_w(B):
    """The one-warp-per-env solve at each W of its launch (4, 8, 16, 32 warps
    per block) equals the plain version and the one-thread kernel bit for
    bit, on whole and ragged 32-env blocks; the scalar staging path (a B
    that is no multiple of 4) as well as the 16-byte one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from puppax_torch.probes import common
    from puppax_torch.probes import pallas_spd_poc as S

    A, b = (torch.from_numpy(x).cuda() for x in S.spd_inputs(B, seed=3))
    A_t, b_t = S.to_lanes(A, b)
    want = S.spd_solve_rows(A_t, b_t)
    one = torch.empty_like(b_t)
    S.spd_solve_one_thread(A_t, b_t, one)
    for warps in S.WARPS:
        x = torch.full_like(b_t, float("nan"))
        S.spd_solve(A_t, b_t, x, warps)
        torch.cuda.synchronize()
        assert common.compare_exact([x], [want]) == (0.0, 0), warps
        assert common.compare_exact([x], [one]) == (0.0, 0), warps


@pytest.mark.parametrize("B", [4096, 300])
def test_p7_team_fk_matches_plain(env, B):
    """P7's team build (the fk cut with its substep loop partitioned) and the
    one-thread fk cut on random states equal the plain fk cut bit for bit
    (``profile_overhead.check_fk``), one counted launch each."""
    from puppax_torch.probes import profile_overhead as P
    from puppax_torch.probes import common

    s = env._s
    dr = env.dr_rows(B).cpu().numpy()
    blocks = [b.cuda() for b in H.to_torch(
        H.physics_step_blocks(env.model, dr, np.random.RandomState(B + 3), n=B))]
    if B % common.TILE:  # the one-thread probe shell takes whole 128-env blocks
        with pytest.raises(ValueError):
            P.check_fk(s, 5, blocks)
        outs = common.empty_outputs(s, B, "cuda")
        before = common.launches[P.FK_TEAM]
        P.fk_step(s, 5, blocks, outs, team=True)
        want = soa.physics_step_rows(s, 5, *blocks, phase_limit="fk", sink=True)
        torch.cuda.synchronize()
        assert common.compare_exact(outs, want) == (0.0, 0)
        assert common.launches[P.FK_TEAM] == before + 1
        return
    before = common.launches[P.FK], common.launches[P.FK_TEAM]
    res = P.check_fk(s, 5, blocks)
    assert res["differing"] == 0 and res["one_thread"]["differing"] == 0
    assert (common.launches[P.FK], common.launches[P.FK_TEAM]) == (before[0] + 1, before[1] + 1)


# ---- run12's env: history 4, the privileged rows, the clock, the curriculum ----


@pytest.fixture(scope="module")
def run12():
    """run12's env on the card at 5 substeps, its five bodies (team K3, K3,
    team K2 at history 4, team K4, K4) built in one parallel batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU host with "
                    "`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda`")
    from puppax_torch.env.pupper import PupperV3Env

    env = PupperV3Env(device="cuda", **H.run12_kwargs(5))
    s, es = env._s, env._es
    build.build_in_parallel(lambda: build.wrapped_step_team_library(s, es, 5, 1000),
                            lambda: build.wrapped_step_library(s, es, 5, 1000),
                            lambda: build.env_step_team_library(s, es, 5),
                            lambda: build.fused_unroll_team_library(s, es, 5, 4),
                            lambda: build.fused_unroll_library(s, es, 5, 4))
    return env


def test_run12_k3_on_the_card(run12):
    """Team K3 at run12's env on a ragged batch: bit for bit with the
    one-thread K3, within tolerance of the plain version, the privileged
    rows of the envs at the episode limit restored."""
    from puppax_torch.probes import common

    env, B = run12, 300
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = [b.cuda() for b in H.to_torch(H.wrapped_step_blocks(
        s, es, env.model, dr, np.random.RandomState(12), n=B, episode_length=1000))]
    got = soa_env.wrapped_step(s, es, 5, 1000, *blocks)
    one = soa_env.wrapped_step_one_thread(s, es, 5, 1000, *blocks)
    want = soa_env.wrapped_step_rows(s, es, 5, 1000, *blocks)
    torch.cuda.synchronize()
    assert common.compare_exact(got, one) == (0.0, 0)
    aux_rows = soa_env.aux_row_map(es)
    H.assert_wrapped_outputs_close([g.cpu().numpy() for g in got],
                                   [w.cpu().numpy() for w in want], s, es, aux_rows,
                                   "team K3[run12] vs plain")
    done = got[3][1] > 0.5
    r0, n = aux_rows["privileged"]
    f0 = s.nq + s.nv + es.hist
    assert done[2:4].all()
    assert torch.equal(got[4][r0 : r0 + n][:, done], blocks[6][f0 : f0 + n][:, done])


def test_run12_k4_on_the_card(run12):
    """Team K4 at run12's env (the clock on, episodes of 4 steps) over 3
    steps: bit for bit with the one-thread K4, within tolerance of
    ``unroll_rows``."""
    env, B, T = run12, 130, 3
    s, es = env._s, env._es
    layers, blocks = H.fused_unroll_inputs(env, B, T, "elu", 4)
    got = fused_unroll.unroll(s, es, 5, 4, "elu", layers, *blocks)
    one = fused_unroll.unroll_one_thread(s, es, 5, 4, "elu", layers, *blocks)
    want = fused_unroll.unroll_rows(s, es, 5, 4, "elu", layers, *blocks)
    torch.cuda.synchronize()
    assert all(torch.equal(g, o) for g, o in zip(got, one))
    aux_rows = soa_env.aux_row_map(es)
    for t in range(T):
        H.assert_wrapped_outputs_close(
            [x.cpu().numpy() for x in got[:4] + (got[9][t],)],
            [x.cpu().numpy() for x in want[:4] + (want[9][t],)], s, es, aux_rows,
            f"team K4[run12] vs plain, step {t}")
    assert (want[9][:, aux_rows["done"][0]] > 0.5).any()


def test_run12_k2_history4_on_the_card(run12):
    """Team K2 at history 4 (it stores no privileged rows) against its
    plain version at the evaluator's 128 envs."""
    env, B = run12, 128
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    blocks = [b.cuda() for b in H.to_torch(H.env_step_blocks(
        s, es, env.model, dr, np.random.RandomState(13), n=B))]
    got = soa_env.env_step(s, es, 5, *blocks)
    want = soa_env.env_step_rows(s, es, 5, *blocks)
    torch.cuda.synchronize()
    H.assert_env_outputs_close([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
                               s, es, "team K2[hist4] vs plain")


# ---- run9's heightfield terrain: the hfield-sphere pair in every body ----


@pytest.fixture(scope="module")
def run9():
    """run9's env (``dev/run_configs/run9_500m_hfield.json``: a 32 x 32
    heightfield, from its committed tables) on the card at 5 substeps, its
    four team bodies (``[hfield]``) built in one parallel batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU host with "
                    "`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda`")
    import json
    import os

    from puppax_torch.configs import experiment
    from puppax_torch.env.pupper import PupperV3Env

    with open(os.path.join(os.path.dirname(__file__), "..", "dev", "run_configs",
                           "run9_500m_hfield.json")) as f:
        cfg = experiment.from_dict(json.load(f))
    env = PupperV3Env.from_config(cfg.env, device="cuda")
    s, es = env._s, env._es
    build.build_in_parallel(lambda: build.physics_step_team_library(s, 5),
                            lambda: build.env_step_team_library(s, es, 5),
                            lambda: build.wrapped_step_team_library(s, es, 5, 1000),
                            lambda: build.fused_unroll_team_library(s, es, 5, 4))
    return env


def _spread(blocks, seed):
    """The bases spread over the 8 x 8 m grid and past its edge."""
    xy = np.random.RandomState(seed).uniform(-4.4, 4.4, (2, blocks[0].shape[1]))
    blocks[0][0:2] = torch.as_tensor(xy, dtype=torch.float32, device=blocks[0].device)
    return blocks


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_run9_team_kernels_bit_for_bit(run9, kernel):
    """Team K1, K2 and K3 at run9's terrain on a ragged batch of states
    spread over the grid: bit for bit with their plain versions."""
    env, B = run9, 300
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    rng = np.random.RandomState(9)
    if kernel == "K1":
        blocks = _spread([b.cuda() for b in H.to_torch(
            H.physics_step_blocks(env.model, dr, rng, n=B))], 1)
        got, want = soa.step_batched(s, *blocks, 5), soa.physics_step_rows(s, 5, *blocks)
    elif kernel == "K2":
        blocks = _spread([b.cuda() for b in H.to_torch(
            H.env_step_blocks(s, es, env.model, dr, rng, n=B))], 2)
        got, want = soa_env.env_step(s, es, 5, *blocks), soa_env.env_step_rows(s, es, 5, *blocks)
    else:
        blocks = _spread([b.cuda() for b in H.to_torch(H.wrapped_step_blocks(
            s, es, env.model, dr, rng, n=B, episode_length=1000))], 3)
        got = soa_env.wrapped_step(s, es, 5, 1000, *blocks)
        want = soa_env.wrapped_step_rows(s, es, 5, 1000, *blocks)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"team {kernel}[hfield] vs plain: output {i} differs"


def test_run9_team_k4_bit_for_bit(run9):
    """Team K4 at run9's terrain over 3 steps (episodes of 4), the bases
    spread over the grid: bit for bit with ``unroll_rows``."""
    env, B, T = run9, 130, 3
    s, es = env._s, env._es
    layers, blocks = H.fused_unroll_inputs(env, B, T, "elu", 4)
    blocks[0] = blocks[0].clone()
    _spread(blocks, 4)
    got = fused_unroll.unroll(s, es, 5, 4, "elu", layers, *blocks)
    want = fused_unroll.unroll_rows(s, es, 5, 4, "elu", layers, *blocks)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None and w is None) or torch.equal(g, w), \
            f"team K4[hfield] vs plain: output {i} differs"


# ---- jax's threefry: the kernel every draw of the port goes through ----


def test_threefry_kernel_matches_plain(env):
    """``random.threefry`` on the card (``csrc/threefry.cuh``) against its
    plain version on the same card tensors: pairs, bits and uniforms bit for
    bit, normals within 4 ulp; the draws bit for bit with the same calls on
    CPU tensors; each launch counted."""
    from puppax_torch import random

    g = torch.Generator(device="cuda").manual_seed(21)
    keys = torch.randint(-2**31, 2**31, (300, 2), generator=g, device="cuda").to(torch.int32)
    lo = torch.rand(77, generator=g, device="cuda") - 1.0
    hi = lo + 2.0
    before = random.threefry.launches
    for mode in (random.PAIRS, random.BITS, random.UNIFORM, random.NORMAL):
        bounds = (lo, hi) if mode == random.UNIFORM else (None, None)
        got = random.threefry(keys, 77, mode, 5, *bounds).view(torch.int32).to(torch.int64)
        want = random.threefry_rows(keys, 77, mode, 5, *bounds).view(torch.int32).to(torch.int64)
        assert int((got - want).abs().max()) <= (4 if mode == random.NORMAL else 0), mode
    assert random.threefry.launches == before + 4
    k = random.split(random.key(3, "cuda"), 512)
    for fn in (lambda x: random.split(x, 5), lambda x: random.uniform(x, (12,), -1.0, 1.0),
               lambda x: random.bernoulli(x, 0.02, (1,)),
               lambda x: random.choice_p(x, np.array([0.2, 0.8], np.float32)),
               lambda x: random.permutation(x[0], 8192)):
        got, want = fn(k).cpu(), fn(k.cpu())
        if got.dtype.is_floating_point:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


# ---- the capsule-legged Pupper: the capsule pairs, through env.path ----


@pytest.fixture(scope="module")
def capsule(tmp_path_factory):
    """The capsule-legged Pupper (the bundled model's 4 foot spheres as
    capsules of radius 0.015 and half-length 0.02, ``bench.py``'s variant)
    from a file through ``env.path`` and its committed tables, on the card
    at 5 substeps; team K1, K2, K3 and K4 (episode 4) ``[capsule]`` built
    in one parallel batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU host with "
                    "`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda`")
    import xml.etree.ElementTree as ET

    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.model import assets

    tree = assets.pupper_xml_tree()
    feet = [g for g in tree.getroot().iter("geom")
            if g.get("type") == "sphere" and g.get("size") == "0.01995"]
    assert len(feet) == 4
    for geom in feet:
        geom.set("type", "capsule")
        geom.set("size", "0.015 0.02")
    path = tmp_path_factory.mktemp("capsule") / "pupper_capsule.xml"
    path.write_text(ET.tostring(tree.getroot(), encoding="unicode"))
    env = PupperV3Env(path=str(path), device="cuda", **H.env_kwargs(5))
    s, es = env._s, env._es
    assert build.model_variant(s) == "capsule"
    build.build_in_parallel(lambda: build.physics_step_team_library(s, 5),
                            lambda: build.env_step_team_library(s, es, 5),
                            lambda: build.wrapped_step_team_library(s, es, 5, 1000),
                            lambda: build.fused_unroll_team_library(s, es, 5, 4))
    return env


def _stand(env, blocks):
    """Every other base lowered onto its capsule feet (the plane-capsule rows
    active), the rest as drawn."""
    blocks[0][2, ::2] = 0.12
    return blocks


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_capsule_team_kernels_bit_for_bit(capsule, kernel):
    """Team K1, K2 and K3 ``[capsule]`` on a ragged batch of states, half
    of them standing on the capsule feet: bit for bit with their plain
    versions (``test_run9_team_kernels_bit_for_bit``'s form)."""
    env, B = capsule, 300
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    rng = np.random.RandomState(20)
    if kernel == "K1":
        blocks = _stand(env, [b.cuda() for b in H.to_torch(
            H.physics_step_blocks(env.model, dr, rng, n=B))])
        got, want = soa.step_batched(s, *blocks, 5), soa.physics_step_rows(s, 5, *blocks)
    elif kernel == "K2":
        blocks = _stand(env, [b.cuda() for b in H.to_torch(
            H.env_step_blocks(s, es, env.model, dr, rng, n=B))])
        got, want = soa_env.env_step(s, es, 5, *blocks), soa_env.env_step_rows(s, es, 5, *blocks)
    else:
        blocks = _stand(env, [b.cuda() for b in H.to_torch(H.wrapped_step_blocks(
            s, es, env.model, dr, rng, n=B, episode_length=1000))])
        got = soa_env.wrapped_step(s, es, 5, 1000, *blocks)
        want = soa_env.wrapped_step_rows(s, es, 5, 1000, *blocks)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"team {kernel}[capsule] vs plain: output {i} differs"


def test_capsule_team_k4_bit_for_bit(capsule):
    """Team K4 ``[capsule]`` over 3 steps (episodes of 4) from a reset of
    130 envs: bit for bit with ``unroll_rows``
    (``test_run9_team_k4_bit_for_bit``'s form)."""
    env, B, T = capsule, 130, 3
    s, es = env._s, env._es
    layers, blocks = H.fused_unroll_inputs(env, B, T, "elu", 4)
    got = fused_unroll.unroll(s, es, 5, 4, "elu", layers, *blocks)
    want = fused_unroll.unroll_rows(s, es, 5, 4, "elu", layers, *blocks)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None and w is None) or torch.equal(g, w), \
            f"team K4[capsule] vs plain: output {i} differs"


# ---- run8's obstacle terrain: the sphere-box pairs as loops over the boxes ----


@pytest.fixture(scope="module")
def run8():
    """run8's env (``dev/run_configs/run8_500m_obstacles.json``: 20 boxes,
    from its committed tables) on the card at 5 substeps, team K3, the
    one-thread K3 and team K2 (``[boxes]``, the default lane's), team K1
    (the physics-only lane's) and team K4 (the fused lane's, episode 1000)
    built in one parallel batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU host with "
                    "`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda`")
    import json
    import os

    from puppax_torch.configs import experiment
    from puppax_torch.env.pupper import PupperV3Env

    with open(os.path.join(os.path.dirname(__file__), "..", "dev", "run_configs",
                           "run8_500m_obstacles.json")) as f:
        cfg = experiment.from_dict(json.load(f))
    env = PupperV3Env.from_config(cfg.env, device="cuda")
    s, es = env._s, env._es
    build.build_in_parallel(lambda: build.wrapped_step_team_library(s, es, 5, 1000),
                            lambda: build.wrapped_step_library(s, es, 5, 1000),
                            lambda: build.env_step_team_library(s, es, 5),
                            lambda: build.physics_step_team_library(s, 5),
                            lambda: build.fused_unroll_team_library(s, es, 5, 1000))
    return env


def _run8_blocks(env, B, seed=8):
    """K3's input blocks of ``B`` random states of run8 on the card, the
    even envs' bases moved onto the boxes."""
    s, es = env._s, env._es
    dr = soa.dr_rows_block(s, soa.dr_inputs(env.model, s, B)).numpy()
    rng = np.random.RandomState(seed)
    blocks = H.wrapped_step_blocks(s, es, env.model, dr, rng, n=B, episode_length=1000)
    blocks[0] = H.place_over_boxes(env.model, blocks[0].T, rng, range(0, B, 2)).T.copy()
    assert H.box_contacts(env.model, blocks[0].T).sum() >= B // 4
    return [b.cuda() for b in H.to_torch(blocks)]


def _run8_k1_blocks(env, B, seed=8):
    """Team K1's (q, v, ctrl, dr) of ``_run8_blocks``: ctrl the action's
    motor targets."""
    q, v, act, _, _, dr = _run8_blocks(env, B, seed)[:6]
    ctrl = (env._es.action_scale * act + env._dev["default_pose"][:, None]).contiguous()
    return [q, v, ctrl, dr]


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_run8_team_kernels_bit_for_bit(run8, kernel):
    """Team K1, K2, K3 and K4 (T = 2) at run8's terrain on a ragged batch
    of states, the even envs' bases on the boxes: bit for bit with their
    plain versions (and team K3 with the one-thread K3), spheres on boxes."""
    from puppax_torch.probes import common

    env, B = run8, 300
    s, es = env._s, env._es
    if kernel == "K1":
        blocks = _run8_k1_blocks(env, B)
        got = soa.step_batched(s, *blocks, 5)
        want = soa.physics_step_rows(s, 5, *blocks)
    elif kernel == "K4":
        layers, blocks = H.fused_unroll_inputs(env, B, 2, "elu", 1000)
        q = H.place_over_boxes(env.model, blocks[0].t().cpu().numpy(), np.random.RandomState(8),
                               range(0, B, 2))
        assert H.box_contacts(env.model, q).sum() >= B // 4
        blocks[0] = torch.from_numpy(q.T.copy()).cuda()
        before = fused_unroll.unroll.launches
        got = fused_unroll.unroll(s, es, 5, 1000, "elu", layers, *blocks)
        want = fused_unroll.unroll_rows(s, es, 5, 1000, "elu", layers, *blocks)
        assert fused_unroll.unroll.launches == before + 1
        got, want = [x for x in got if x is not None], [x for x in want if x is not None]
    elif kernel == "K2":
        blocks = _run8_blocks(env, B)
        got = soa_env.env_step(s, es, 5, *blocks[:6])
        want = soa_env.env_step_rows(s, es, 5, *blocks[:6])
    else:
        blocks = _run8_blocks(env, B)
        got = soa_env.wrapped_step(s, es, 5, 1000, *blocks)
        one = soa_env.wrapped_step_one_thread(s, es, 5, 1000, *blocks)
        want = soa_env.wrapped_step_rows(s, es, 5, 1000, *blocks)
        torch.cuda.synchronize()
        assert common.compare_exact(got, one) == (0.0, 0)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"team {kernel}[boxes] vs plain: output {i} differs"


def test_run8_team_k1_scratch_across_batch_sizes(run8):
    """One team K1[boxes] library at 128, then 4096, then 128 envs (the
    physics-only lane's evaluator and trainer in one process): every launch
    bit for bit with the plain version, and a CUDA graph captured at 128
    before the 4096 launch (which binds a larger scratch) still replays
    right after it (``build.bind_scratch`` frees no scratch a capture may
    hold)."""
    env = run8
    s = env._s
    small = _run8_k1_blocks(env, 128, seed=9)
    big = [x.repeat(1, 32) for x in small]  # 4096 envs: the 128 states 32 times
    want_small = soa.physics_step_rows(s, 5, *small)
    want_big = soa.physics_step_rows(s, 5, *big)
    got = soa.step_batched(s, *small, 5)  # binds the scratch for 128 envs
    assert all(torch.equal(g, w) for g, w in zip(got, want_small)), "team K1[boxes] at 128"
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = soa.step_batched(s, *small, 5)
    torch.cuda.synchronize()
    got = soa.step_batched(s, *big, 5)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want_big)), "team K1[boxes] at 4096"
    for out in captured:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(captured, want_small)), "the graph at 128"
    got = soa.step_batched(s, *small, 5)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want_small)), "team K1[boxes] at 128"
