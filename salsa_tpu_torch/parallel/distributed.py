"""Data parallelism across processes (counterpart of
`salsa_tpu.parallel.distributed`).

One process per rank, each driving one device, the ranks joined in a
`torch.distributed` process group: NCCL where every rank has a card of its own,
gloo on the CPU and where ranks share a card (NCCL refuses two ranks on one
device; gloo takes CUDA tensors and copies them through the host inside the
collective). `initialize` forms the group from the environment of either
launcher:

    SALSA_COORDINATOR=host:port SALSA_NUM_PROCESSES=2 SALSA_PROCESS_ID=i  (salsa_tpu's)
    torchrun --nproc_per_node=N ...  (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
                                      LOCAL_RANK)

and is a no-op with neither. Every rank runs the same program on its own rows of
one global batch (`local_batch_slice`); `all_reduce_sum` and `broadcast` are the
collectives the trainer needs (gradients and global loss denominators summed,
rank 0's parameters sent once); writes to disk are rank 0's (`is_primary`).

`salsa_tpu`'s `global_batch_from_local` and `make_replicated` have no torch
meaning and no counterpart here: a rank keeps its local rows as ordinary tensors,
and rank 0's parameters are broadcast once (`mesh.replicate`) instead of being
laid out as one global array.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# a collective waits this long for the other ranks (rank 0 validates and writes
# checkpoints while the others wait at the next step's first collective)
DEFAULT_TIMEOUT_S = 1800.0


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def local_rank() -> int:
    """This process's index among the ranks of its host: torchrun's LOCAL_RANK,
    else SALSA_PROCESS_ID (a `SALSA_*` launch is taken as one host), else 0."""
    for name in ("LOCAL_RANK", "SALSA_PROCESS_ID"):
        v = _env_int(name)
        if v is not None:
            return v
    return 0


def local_device() -> torch.device:
    """The rank's card, cuda:{local_rank % device_count} (ranks share cards when
    there are more ranks than cards), or the CPU on a host without one."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def default_backend(world_size: int) -> str:
    """NCCL where the host's ranks have a card each, else gloo."""
    if not torch.cuda.is_available():
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Form the process group (`default_backend`'s); returns whether there is one.
    The arguments win over SALSA_COORDINATOR / SALSA_NUM_PROCESSES /
    SALSA_PROCESS_ID, which win over torchrun's MASTER_ADDR:MASTER_PORT /
    WORLD_SIZE / RANK. No-op (False) with none of them; a group formed earlier is
    kept."""
    if is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("SALSA_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SALSA_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SALSA_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        if "MASTER_ADDR" not in os.environ or _env_int("WORLD_SIZE") is None:
            return False
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
        num_processes, process_id = _env_int("WORLD_SIZE"), _env_int("RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process launch needs the coordinator's host:port, the "
                         "number of processes and this process's index (SALSA_COORDINATOR, "
                         "SALSA_NUM_PROCESSES, SALSA_PROCESS_ID)")
    backend = default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group, where there is one."""
    if is_initialized():
        dist.destroy_process_group()


def barrier(name: str) -> None:
    """Align every rank (`name` says where, for a reader of a hang); no-op with
    one rank. Ranks meet here before their first collective, so that a slow
    setup on one of them (data loading, tracker checkpoints) does not count
    against a collective."""
    del name
    if process_count() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def local_batch_slice(global_batch_size: int) -> slice:
    """This rank's [start, stop) rows of a global batch, which must divide by the
    number of ranks (ValueError otherwise)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    per = global_batch_size // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, in place (returned); `t` itself with one rank."""
    if process_count() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """`t` overwritten, in place, by rank `src`'s (returned); no-op with one rank."""
    if process_count() > 1:
        dist.broadcast(t, src)
    return t


def gather_objects(obj) -> list | None:
    """Every rank's `obj` (picklable) as a list on rank 0, None elsewhere; [obj]
    with one rank."""
    if process_count() <= 1:
        return [obj]
    out = [None] * process_count() if is_primary() else None
    dist.gather_object(obj, out, dst=0)
    return out
