"""Multi-process entry points: join the process group, the global mesh,
liveness and replica checks.

Counterpart of :mod:`diasss_tpu.parallel.distributed`.  One process per
rank joins through :func:`initialize` (torchrun's ``env://`` by default, as
the JAX package reads its coordinator environment; or an explicit
``tcp://HOST:PORT`` / ``file://PATH``, world size and rank).  The JAX
package's silent drop to one chip when fewer devices exist than asked is on
ROADMAP's not-to-port list: here a mesh larger than the world raises
(:func:`.shard.make_mesh`).

Every group gets a timeout (:data:`TIMEOUT_S`), so a hung rank fails the
run instead of holding it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .collectives import Mesh, all_gather, psum

TIMEOUT_S = 300.0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group (``dist.init_process_group`` wrapper).

    With no arguments, reads torchrun's environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``backend``
    is ``"nccl"`` (one rank per GPU, the default) or ``"gloo"`` (CPU ranks,
    or several ranks sharing one GPU), never chosen on the caller's behalf:
    without CUDA the default raises.  With nccl the rank's current CUDA
    device is set to ``LOCAL_RANK`` (else the rank) modulo the device
    count."""
    if backend is None:
        _require_cuda('backend="gloo" with a CPU device (--device cpu on the command line)')
        backend = "nccl"
    kwargs = dict(backend=backend, init_method=init_method or "env://",
                  timeout=datetime.timedelta(seconds=timeout_s))
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


def _require_cuda(cpu_choice: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: the multi-device layer runs on the card unless the caller asks for the CPU; "
            f"pass {cpu_choice}")


def default_device() -> torch.device:
    """This rank's device: the current CUDA device (set by
    :func:`initialize` under nccl).  Raises where CUDA is absent: CPU ranks
    name their device, ``device="cpu"`` (``--device cpu`` on the command
    line), as every entry point of the port does."""
    _require_cuda('device="cpu" (--device cpu on the command line)')
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(device=None) -> Mesh:
    """The mesh over every rank of the default group; ``device`` is where
    this rank computes (default :func:`default_device`)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() or run under torchrun")
    n = dist.get_world_size()
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=n,
                device=torch.device(device) if device is not None else default_device(),
                transport=dist.get_backend(), ranks=tuple(range(n)))


def is_primary() -> bool:
    """Rank 0 of the default group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def heartbeat(mesh: Mesh) -> int:
    """Liveness check: every rank contributes 1 to one all-reduce and the
    sum must equal the mesh size.  A dead or partitioned rank never reaches
    the collective, so callers run this under a wall-clock watchdog
    (:func:`.recovery.heartbeat_probe`) and treat a hang or a short count
    as peer failure.  Returns the ranks that took part."""
    return int(psum(mesh, torch.ones(1, dtype=torch.int64, device=mesh.device)).item())


def replica_divergence(tree, mesh: Mesh) -> float:
    """Largest absolute gap between the ranks' copies of logically
    replicated tensors (every leaf of ``tree``): one all-gather per leaf,
    each copy against rank 0's.  Nonzero means the replicas diverged
    (an order-dependent reduction, rank-dependent input, or a fault)."""
    from torch.utils import _pytree as pytree

    worst = 0.0
    for leaf in pytree.tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor) or leaf.numel() == 0 or leaf.dtype == torch.bool:
            continue
        g = all_gather(mesh, leaf).to(torch.float64)
        worst = max(worst, float((g - g[:1]).abs().max()))
    return worst
