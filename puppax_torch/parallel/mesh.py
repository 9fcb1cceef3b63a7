"""The process group, the env mesh and the rank's share of the env batch.

Counterpart of ``puppax/parallel/mesh.py:23-81``. The JAX package runs one
process per host over a global ``Mesh(("env",))``: the env batch is
sharded over every chip, parameters are replicated, and XLA inserts the
gradient all-reduce. PyTorch's idiom is one process per GPU instead: a
launcher starts one process per card (``python -m torch.distributed.run
--nproc_per_node N -m puppax_torch.scripts.train``), each process is one
rank of a ``torch.distributed`` process group on its own device
(``cuda:LOCAL_RANK``), holds ``num_envs / world`` envs, and the learner
issues its collectives itself (``all_reduce_``, ``all_gather``). So a
single process given several devices raises (``make_env_mesh``): there is
no in-process mesh over cards.

``env_sharding`` and ``replicated_sharding`` become the rank's row slice
of a batch and the whole of it; ``shard_env_batch`` takes the rank's rows
of each leaf's leading axis.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from puppax_torch import utils

ENV_AXIS = "env"

LAUNCHER = "python -m torch.distributed.run --nproc_per_node N"

# collectives issued over a process group, by what they carry (the
# learner's gradient all-reduces are "grads"); a world without a process
# group issues none
calls: Dict[str, int] = {}


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def rank_device() -> torch.device:
    """This process's card, ``cuda:LOCAL_RANK`` (``cuda:0`` without a
    launcher); it raises without a card (``utils.resolve_device``)."""
    return utils.resolve_device(torch.device("cuda", _env_int("LOCAL_RANK") or 0))


def maybe_initialize_distributed(device=None, **kwargs) -> bool:
    """Join the process group if this process was started as one rank of
    several; a no-op in a single-process run.

    The group's address comes from explicit ``kwargs``
    (``coordinator_address``, ``num_processes``, ``process_id``), the
    ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` variables
    (``puppax``'s), or a launcher's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE`` (``torch.distributed.run``'s: the counterpart
    of a cluster env jax detects). ``device`` is the rank's device (default
    ``rank_device()``): NCCL on a CUDA device, gloo on the CPU; there is no
    fallback from one to the other. Returns True when the group is (or
    already was) live, False without an address. A failure raises: a rank
    that trains alone would train on its share of the envs only.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = kwargs.get("coordinator_address") or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is not None:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world = kwargs.get("num_processes", _env_int("NUM_PROCESSES"))
        rank = kwargs.get("process_id", _env_int("PROCESS_ID"))
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world = kwargs.get("num_processes", _env_int("WORLD_SIZE"))
        rank = kwargs.get("process_id", _env_int("RANK"))
    else:
        return False  # a single-process run
    if world is None or rank is None:
        raise ValueError(f"the process group at {coordinator} needs its world size and rank "
                         f"(NUM_PROCESSES and PROCESS_ID, or num_processes= and process_id=)")
    device = rank_device() if device is None else utils.resolve_device(device)
    if not dist.is_available():
        raise RuntimeError("this torch has no torch.distributed")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, world_size=int(world),
                                rank=int(rank), device_id=device)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=int(world),
                                rank=int(rank))
    return True


@dataclass(frozen=True)
class EnvMesh:
    """One rank's view of the 1-D ``"env"`` mesh: the world's size, this
    rank, its device, and the group's backend (None: a single process, no
    collectives)."""

    world: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    axis_name: str = ENV_AXIS

    @property
    def is_lead(self) -> bool:
        """Rank 0, the one writer of checkpoints, metrics and artifacts."""
        return self.rank == 0


def make_env_mesh(devices=None) -> EnvMesh:
    """This rank's mesh over the process group (a world of one without a
    group) on ``devices[0]`` (default, or None: ``rank_device()``). More than one
    device raises: each card is a process of its own under the launcher."""
    import torch.distributed as dist

    devices = list(devices) if devices is not None else [rank_device()]
    if len(devices) != 1:
        raise ValueError(
            f"one process trains on one device, not {len(devices)}: start one process per "
            f"GPU with `{LAUNCHER} -m puppax_torch.scripts.train` (PyTorch's idiom; the JAX "
            f"package's single-process mesh over devices has no counterpart here)")
    device = rank_device() if devices[0] is None else utils.resolve_device(devices[0])
    if not (dist.is_available() and dist.is_initialized()):
        return EnvMesh(1, 0, device)
    backend = str(dist.get_backend())
    if (backend == "nccl") != (device.type == "cuda"):
        raise ValueError(f"the process group runs {backend}, the rank's device is {device}")
    return EnvMesh(dist.get_world_size(), dist.get_rank(), device, backend)


def env_sharding(mesh: EnvMesh, n: int) -> slice:
    """The rank's rows of an ``n``-row env batch (``n % world == 0``)."""
    if n % mesh.world:
        raise ValueError(f"{n} envs do not split over {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated_sharding(mesh: EnvMesh) -> slice:
    """Every row: a replicated leaf (parameters, optimizer state, scalars)."""
    return slice(None)


def shard_env_batch(tree, mesh: EnvMesh):
    """The rank's rows of every tensor leaf's leading axis (dicts, lists,
    tuples and dataclasses are walked; scalars and non-tensors stay)."""
    if isinstance(tree, torch.Tensor):
        return tree[env_sharding(mesh, tree.shape[0])] if tree.ndim else tree
    if isinstance(tree, dict):
        return {k: shard_env_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_env_batch(v, mesh) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: shard_env_batch(getattr(tree, f.name), mesh)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def all_reduce_(x: torch.Tensor, mesh: Optional[EnvMesh], what: str) -> torch.Tensor:
    """Sum ``x`` over the ranks in place (``psum``) and return it; without
    a process group (or a mesh) ``x`` as it is. ``what`` names the count it
    adds to."""
    if mesh is None or mesh.backend is None:
        return x
    import torch.distributed as dist

    dist.all_reduce(x)
    calls[what] = calls.get(what, 0) + 1
    return x


def all_gather(x: torch.Tensor, mesh: EnvMesh, what: str) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``(world, *x.shape)``;
    without a process group ``x[None]``."""
    if mesh.backend is None:
        return x[None]
    import torch.distributed as dist

    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(out, x)
    calls[what] = calls.get(what, 0) + 1
    return torch.stack(out)
