"""puppax_torch.parallel: the process group, the env mesh and the rank's
share of the env batch (``puppax/parallel``'s counterpart)."""

from puppax_torch.parallel.mesh import (  # noqa: F401
    ENV_AXIS,
    EnvMesh,
    all_gather,
    all_reduce_,
    env_sharding,
    make_env_mesh,
    maybe_initialize_distributed,
    replicated_sharding,
    shard_env_batch,
)
