"""The policy side of PPO: normalizer, action distribution, networks."""
