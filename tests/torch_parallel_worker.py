"""One rank of the port's two-rank CPU runs (``tests/test_torch_parallel.py``).

    python tests/torch_parallel_worker.py MODE RANK WORLD ADDRESS OUT [CLI ARGS...]

Each mode joins a gloo process group through
``puppax_torch.parallel.maybe_initialize_distributed`` by another route and
writes what the test reads to ``OUT/rank<RANK>.pt``:

* ``mesh``: the launcher's variables (``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK``, ``WORLD_SIZE``, as ``torch.distributed.run`` sets them): the
  rank's mesh, its slices and one all-reduce and all-gather;
* ``step``: explicit arguments (``coordinator_address=``,
  ``num_processes=``, ``process_id=``): the rank's share of 8 envs reset
  from ``split(PRNGKey(7), 8)`` and stepped 3 times on its rows of one
  numpy-seeded action block;
* ``cli``: ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
  (the JAX package's variables): the training CLI
  (``puppax_torch.scripts.train.main``) on the given arguments, its final
  params captured from ``ppo.train`` and its writes counted.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _mesh(rank, world, address):
    from puppax_torch.parallel import mesh as mesh_lib

    host, port = address.rsplit(":", 1)
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    assert mesh_lib.maybe_initialize_distributed(device="cpu")
    assert mesh_lib.maybe_initialize_distributed(device="cpu")  # already live
    mesh = mesh_lib.make_env_mesh(["cpu"])
    tree = {"a": torch.arange(8.0), "b": [torch.arange(16).reshape(8, 2)], "c": torch.tensor(3.0)}
    x = torch.full((3,), float(rank + 1))
    return {
        "mesh": (mesh.world, mesh.rank, str(mesh.device), mesh.backend, mesh.axis_name),
        "rows": mesh_lib.env_sharding(mesh, 8),
        "sharded": mesh_lib.shard_env_batch(tree, mesh),
        "psum": mesh_lib.all_reduce_(x, mesh, "test").clone(),
        "gathered": mesh_lib.all_gather(torch.tensor([rank, 10 + rank]), mesh, "test"),
        "calls": dict(mesh_lib.calls),
    }


def _step(rank, world, address):
    import torch_port_helpers as H
    from puppax_torch import random
    from puppax_torch.parallel import mesh as mesh_lib

    assert mesh_lib.maybe_initialize_distributed(
        device="cpu", coordinator_address=address, num_processes=world, process_id=rank)
    mesh = mesh_lib.make_env_mesh(["cpu"])
    env = H.torch_env()
    keys = mesh_lib.shard_env_batch(random.split(random.key(7), 8), mesh)
    actions = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (3, 8, 12))
                               .astype(np.float32))
    state = env.reset(keys)
    traj = []
    for t in range(3):
        state = env.step(state, mesh_lib.shard_env_batch(actions[t], mesh))
        traj.append((state.obs.clone(), state.reward.clone()))
    return {"traj": traj}


def _cli(rank, world, address, argv):
    from puppax_torch.parallel import mesh as mesh_lib
    from puppax_torch.scripts import train as train_cli
    from puppax_torch.train import checkpoint, ppo

    os.environ.update(COORDINATOR_ADDRESS=address, NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    got, saves = {}, []
    train, save = ppo.train, checkpoint.save_checkpoint

    def train_spy(*a, **kw):
        make_policy, params, metrics = train(*a, **kw)
        got["params"] = ppo.params_state_dict(params)
        return make_policy, params, metrics

    def save_spy(step, tree, path):
        saves.append((int(step), str(path)))
        return save(step, tree, path)

    ppo.train, checkpoint.save_checkpoint = train_spy, save_spy
    metrics = train_cli.main(argv)
    return {"params": got["params"], "metrics": metrics, "saves": saves,
            "calls": dict(mesh_lib.calls)}


def main():
    mode, rank, world, address, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    if mode == "mesh":
        result = _mesh(rank, world, address)
    elif mode == "step":
        result = _step(rank, world, address)
    else:
        result = _cli(rank, world, address, sys.argv[6:])
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
