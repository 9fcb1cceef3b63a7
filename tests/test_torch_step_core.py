"""The physics-only lane: the env layer in torch around the physics step.

With ``PUPPAX_SOA_ENV=off`` the port's ``PupperV3Env`` steps through
``_step_core`` (kick, action latency, motor targets, observation, foot
contacts, termination, the 18 rewards of ``env/rewards.py``, the carried
fields) around one ``pipeline.make_batched_step`` call: K1 on the card,
its plain version here. It is held against

* ``puppax``'s wrapped ``step`` under the same setting
  (AutoReset(Vmap(Episode(env))) with DR; the XLA step core and physics)
  over 2 steps of 1 substep on the draws its key chain makes: env 1
  enters done (the AutoReset prologue), envs 2-3 reach the episode limit
  (truncation) and env 0 starts with a hip past its joint limit (a
  termination). The other envs start from their reset states, feet on
  the floor, inside the MJX caps. obs and reward within 2e-4, done and
  truncation exact;
* the port's fused lane (K2's plain version) on the same inputs, to 1e-5:
  both run the same emitted physics on the CPU;

and ``rollout.support_reason`` names why ``ppo.train`` leaves the fast
lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from puppax.env import domain_randomization as jdr
from puppax.env import wrappers as jwrappers
from puppax_torch.env import rollout, soa_env
from puppax_torch.env.base import state_from_jax
from puppax_torch.env.wrappers import wrap_for_training

torch.set_num_threads(1)

L = 3  # episode length: envs 2-3 truncate on step 1
T = 2


def _wrapped_torch(leaves):
    return wrap_for_training(
        H.torch_env(), L, randomization_fn=lambda m, keys: m.with_leaves(**leaves),
        randomization_keys=H.env_keys(H.B),
    )


@pytest.fixture(scope="module")
def runs():
    """puppax's wrapped env under PUPPAX_SOA_ENV=off, its reset state with
    env 0 past a joint limit, env 1 done and envs 2-3 at the episode limit;
    its 2 steps on its own draws; the port's physics-only and fused wrapped
    envs with the same DR leaves."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PUPPAX_SOA_ENV", "off")
        jenv = H.jax_env()
        jwrapped = jwrappers.wrap_for_training(
            jenv, L, randomization_fn=jdr.domain_randomize,
            randomization_rng=jax.random.split(jax.random.PRNGKey(5), H.B),
        )
        jstate = jax.jit(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(3), H.B))
        steps = np.zeros(H.B, np.float32)
        steps[2:4] = L - 1
        done = np.zeros(H.B, np.float32)
        done[1] = 1.0
        qpos = np.array(jstate.pipeline_state.qpos)
        qpos[0, 7] = jenv.lowers[0] - 0.4
        jstate = jstate.replace(
            done=jnp.asarray(done), info=dict(jstate.info, steps=jnp.asarray(steps)),
            pipeline_state=jstate.pipeline_state.replace(qpos=jnp.asarray(qpos)),
        )
        start = jax.tree_util.tree_map(np.asarray, jstate)
        jstep = jax.jit(jwrapped.step)
        draw = jax.jit(jax.vmap(jenv._draw_step_noise))
        rng = np.random.RandomState(9)
        noises, acts, jstates = [], [], []
        for _ in range(T):
            noises.append({k: torch.from_numpy(np.array(v))
                           for k, v in draw(jstate.info["rng"]).items()
                           if k in jenv._CORE_NOISE_KEYS})
            acts.append(rng.uniform(-1, 1, (H.B, 12)).astype(np.float32))
            jstate = jstep(jstate, jnp.asarray(acts[-1]))
            jstates.append(jax.tree_util.tree_map(np.asarray, jstate))
        leaves = H.dr_leaves(jwrapped.env._model)
        physics_only = _wrapped_torch(leaves)
    fused = _wrapped_torch(leaves)
    assert not physics_only.env._use_soa_env and fused.env._use_soa_env
    return start, noises, acts, jstates, physics_only, fused


def _run(wrapped, start, noises, acts):
    state = state_from_jax(start)
    out = []
    for noise, act in zip(noises, acts):
        state = wrapped.step_from_draws(state, torch.from_numpy(act), noise)
        out.append(state)
    return out


def test_physics_only_step_matches_jax(runs, monkeypatch):
    start, noises, acts, jstates, physics_only, _ = runs
    # the physics-only lane never reaches K2 or its plain version
    monkeypatch.setattr(soa_env, "env_step", lambda *a: pytest.fail("K2 lane taken"))
    close = np.testing.assert_allclose
    for t, (tstate, j) in enumerate(zip(_run(physics_only, start, noises, acts), jstates)):
        what = f"step {t}"
        np.testing.assert_array_equal(tstate.done.numpy(), j.done, err_msg=what)
        for name in ("steps", "truncation", "step", "last_contact"):
            np.testing.assert_array_equal(tstate.info[name].numpy(), j.info[name],
                                          err_msg=f"{what} {name}")
        close(tstate.obs.numpy(), j.obs, atol=2e-4, err_msg=f"{what} obs")
        close(tstate.reward.numpy(), j.reward, atol=2e-4, err_msg=f"{what} reward")
        for k, v in tstate.info["rewards"].items():
            w = j.info["rewards"][k]
            close(v.numpy(), w, atol=2e-4 * max(1.0, np.abs(w).max()), err_msg=f"{what} {k}")
        close(tstate.qpos.numpy(), j.pipeline_state.qpos, atol=5e-5, err_msg=f"{what} qpos")
        scale = np.maximum(1.0, np.abs(j.pipeline_state.qvel).max(1, keepdims=True))
        close(tstate.qvel.numpy() / scale, j.pipeline_state.qvel / scale, atol=5e-4,
              err_msg=f"{what} qvel")
        for name in ("command", "desired_world_z_in_body_frame", "last_act", "kick",
                     "action_buffer", "imu_buffer", "feet_air_time"):
            close(tstate.info[name].numpy(), j.info[name], atol=2e-4, err_msg=f"{what} {name}")
        close(tstate.metrics["total_dist"].numpy(), j.metrics["total_dist"], atol=1e-4)
        if t == 0:
            assert j.done[0] == 1 and j.info["truncation"][0] == 0
            assert (j.info["truncation"][2:4] == 1).all()
    counts = H.penetrating_pairs(physics_only.env._s, tstate.pipeline_state.contact_dist.t())
    assert H.within_caps(physics_only.env.model, counts).all() and counts[:, 0].any()


def test_physics_only_lane_matches_fused_lane(runs):
    start, noises, acts, _, physics_only, fused = runs
    for t, (a, b) in enumerate(zip(_run(physics_only, start, noises, acts),
                                   _run(fused, start, noises, acts))):
        for name in ("done", "reward", "obs", "qpos", "qvel"):
            torch.testing.assert_close(getattr(a, name), getattr(b, name), atol=1e-5, rtol=0,
                                       msg=f"step {t} {name}")
        for name in ("qacc", "xpos", "x_rot", "xd_vel", "site_xpos", "contact_dist"):
            torch.testing.assert_close(getattr(a.pipeline_state, name),
                                       getattr(b.pipeline_state, name), atol=1e-4, rtol=0,
                                       msg=f"step {t} caches {name}")
        for name in ("step", "last_contact", "steps", "truncation"):
            assert torch.equal(a.info[name], b.info[name]), name


def test_support_reason_names_the_lane(runs, monkeypatch):
    *_, physics_only, fused = runs
    assert rollout.support_reason(fused) == (True, "ok")
    ok, why = rollout.support_reason(physics_only)
    assert not ok and "without the fused SoA step core" in why
    monkeypatch.setenv("PUPPAX_FAST_LANE", "off")
    assert rollout.support_reason(fused) == (False, "PUPPAX_FAST_LANE=off")
    monkeypatch.setenv("PUPPAX_SOA_ENV", "off")
    assert rollout.support_reason(fused) == (False, "PUPPAX_SOA_ENV=off")
