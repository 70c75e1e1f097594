"""Several processes, several nodes (counterpart of
``ray_marching_tpu/parallel/multihost.py``).

One process per device, as ``torchrun --nproc-per-node N`` starts them:

* :func:`initialize`: ``torch.distributed.init_process_group`` from the
  arguments or torchrun's environment, a no-op returning False when neither
  configures one;
* :func:`make_global_mesh`: a ``("host", "chip")`` mesh, nodes outermost, so
  the collectives within a node stay on its links;
* :func:`host0_print` / :func:`is_host0`: one writer for logs and metrics;
* :func:`barrier`: a sync point that raises ``TimeoutError`` when a peer
  never arrives, instead of hanging (restart from the latest checkpoint).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

_SIDE_GROUP = {}  # default group -> its gloo side group


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               device: str = "cuda") -> bool:
    """Join the process group: ``coordinator`` ("host:port", else
    ``MASTER_ADDR``:``MASTER_PORT``), ``num_processes`` (else
    ``WORLD_SIZE``) and ``process_id`` (else ``RANK``). On ``device="cuda"``
    the group is NCCL's and the process takes the card ``LOCAL_RANK`` (else
    its rank modulo the node's cards); on ``"cpu"`` it is gloo's. Returns
    True when a group was joined, False when nothing configures one (one
    process)."""
    from ray_marching_tpu_torch.utils import resolve_device

    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or _int_env("WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("RANK")
    if not coordinator or num_processes is None or process_id is None:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device(process_id % torch.cuda.device_count()
                              if local is None else local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        # barrier()'s watchdog: gloo's monitored barrier, on a group made
        # now, while every rank is here to make it.
        _side_group()
    return True


def _int_env(name):
    val = os.environ.get(name)
    return int(val) if val is not None else None


def is_host0() -> bool:
    """True on rank 0, and in a process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host0_print(*args, **kwargs) -> None:
    """Print from rank 0 only (single-writer logs and metrics)."""
    if is_host0():
        print(*args, **kwargs)


def local_world_size() -> int:
    """Processes on this node: ``LOCAL_WORLD_SIZE`` (torchrun sets it), else
    the whole group (one node)."""
    return _int_env("LOCAL_WORLD_SIZE") or dist.get_world_size()


def make_global_mesh(axis_names=("host", "chip"), device_type: str = "cuda"):
    """A 2-D ``DeviceMesh``: nodes on the outer axis, each node's processes
    on the inner one."""
    from torch.distributed.device_mesh import init_device_mesh

    n, local = dist.get_world_size(), local_world_size()
    if n % local:
        raise ValueError(f"{n} ranks are not whole nodes of {local}")
    return init_device_mesh(device_type, (n // local, local),
                            mesh_dim_names=tuple(axis_names))


def _side_group():
    """A gloo group over every rank (the default group itself when it is
    gloo's): ``monitored_barrier`` runs on gloo only."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _SIDE_GROUP:
        _SIDE_GROUP[world] = dist.new_group(backend="gloo")
    return _SIDE_GROUP[world]


def barrier(timeout_s: float = 120.0) -> None:
    """Every rank waits here for the others. A peer that has not arrived
    within ``timeout_s`` (dead, or stuck) raises ``TimeoutError`` naming
    this rank and the world size; a healthy group returns in
    milliseconds."""
    try:
        dist.monitored_barrier(group=_side_group(),
                               timeout=timedelta(seconds=timeout_s))
    except RuntimeError as exc:
        raise TimeoutError(
            f"barrier: not every rank arrived within {timeout_s} s (rank "
            f"{dist.get_rank()} of {dist.get_world_size()}); a peer is "
            "likely dead: restart from the latest checkpoint") from exc
