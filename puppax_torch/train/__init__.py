"""PPO: normalizer, action distribution, networks, acting, the learner and
checkpoints."""
