"""Process-group initialization: one process a card.

Counterpart of ``reductive_tpu.parallel.launch``.  JAX wires one process a
host into one runtime; here each card has its own process, the processes
join one ``torch.distributed`` process group, and every sharded entry of
this package is then called the same way on every rank.  Typical launch
(the same script on every rank)::

    # torchrun --nproc-per-node=8 train.py
    from reductive_tpu_torch.parallel import (
        initialize_distributed, make_mesh, train_pq_chunked_sharded)

    initialize_distributed()          # torchrun's environment (env://)
    mesh = make_mesh()                # 1-D data mesh over every rank
    gen = torch.Generator(device="cuda").manual_seed(0)   # same seed everywhere
    pq = train_pq_chunked_sharded(gen, x, 16, 8, 25, mesh=mesh)

Encode-style jobs need no group at all: each process can run
:func:`reductive_tpu_torch.data.stream_encode_resumable` on its own share of
the corpus and restart on its own.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed"]

logger = logging.getLogger("reductive_tpu")

# Environment variables by which a launcher says that this process is one of
# several.  If one of them does and the group cannot be joined, going on as
# a single process would make every rank train on its own share alone and
# produce divergent models, so initialization raises instead.
_MULTIPROCESS_ENV_SIGNALS = (
    "MASTER_ADDR",           # with a world size above 1
    "WORLD_SIZE",            # > 1 (torchrun, torch.distributed.launch)
    "TORCHELASTIC_RUN_ID",   # presence = a torchrun rendezvous
    "SLURM_NTASKS",          # > 1
    "OMPI_COMM_WORLD_SIZE",  # > 1 (mpirun)
)
_WORLD_SIZE_ENV = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")


def _above_one(name: str) -> bool:
    try:
        return int(os.environ.get(name, "")) > 1
    except ValueError:
        return False


def _multiprocess_intent() -> Optional[str]:
    """The first environment signal of membership in a group of several
    processes."""
    several = [name for name in _WORLD_SIZE_ENV if _above_one(name)]
    if os.environ.get("MASTER_ADDR") and several:
        return "MASTER_ADDR"
    if several:
        return several[0]
    if os.environ.get("TORCHELASTIC_RUN_ID"):
        return "TORCHELASTIC_RUN_ID"
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    ``coordinator_address`` (``host:port``, or a URL such as
    ``tcp://host:port``) becomes the ``init_method``, ``num_processes`` the
    world size and ``process_id`` the rank.  With no arguments the
    launcher's environment is read (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them).
    The backend is NCCL where CUDA is available and gloo otherwise;
    ``backend=`` among ``kwargs`` overrides it, and the other ``kwargs``
    (``timeout=`` ...) go to ``init_process_group``.  On CUDA the process
    takes card ``LOCAL_RANK % device_count()`` (the rank where no launcher
    set ``LOCAL_RANK``), so ``device=None`` means this rank's card.

    Where no arguments are given and the environment's group cannot be
    joined, the process goes on alone in a one-process group (a warning is
    logged), and every sharded entry runs single-process, unless the
    environment says that this process is one of several: then it raises a
    ``RuntimeError``, since each process would train on its share alone.
    """
    if dist.is_initialized():
        return
    backend = kwargs.pop("backend", "nccl" if torch.cuda.is_available() else "gloo")
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    init_method = "env://"
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    try:
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id, **kwargs,
        )
    except (RuntimeError, ValueError) as e:  # DistStoreError is a RuntimeError
        if explicit:
            raise
        signal = _multiprocess_intent()
        if signal is not None:
            raise RuntimeError(
                f"torch.distributed.init_process_group failed ({e}) but the "
                f"environment signals a group of several processes ({signal} is "
                "set). Refusing the silent single-process fallback — pass "
                "coordinator_address/num_processes/process_id explicitly."
            ) from e
        logger.warning(
            "torch.distributed.init_process_group failed (%s); continuing "
            "single-process (no multi-process environment signals present).", e,
        )
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
