"""Joining the job's process group: one process a card.

Counterpart of ``dotaclient_tpu/parallel/distributed.py``. The JAX package
is single-controller: one process drives every device of its mesh and XLA
emits the collectives. The port is SPMD: every rank is a process that holds
one card, its shard of the work, and joins the collectives over
``torch.distributed``. NCCL carries them between cards, gloo between CPU
tensors (and between two ranks that share one card, which NCCL refuses).

Usage, one call a process before the learner is built::

    from dotaclient_tpu_torch.parallel import initialize_runtime
    initialize_runtime()                          # under torch.distributed.run
    initialize_runtime("10.0.0.1:1234", 4, 2)     # explicit: tcp://10.0.0.1:1234

The no-argument form reads what ``python -m torch.distributed.run`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), as the reference's reads the TPU metadata. The learner CLI
wires it as ``--multihost``::

    python -m torch.distributed.run --nproc-per-node K \\
        -m dotaclient_tpu_torch.train.learner --multihost ...

Every collective of the group times out after ``timeout_s``, so a rank that
dies makes the others fail instead of waiting for ever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def default_backend() -> str:
    """NCCL where there is a card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_runtime(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join (or create) the job's default process group. Idempotent: a
    second call is a no-op.

    With no arguments the rendezvous is ``env://`` (what
    ``torch.distributed.run`` sets). With explicit arguments, all three are
    needed; ``coordinator_address`` is ``HOST:PORT`` (made ``tcp://``) or a
    URL (``tcp://`` or ``file://``). ``backend`` picks the transport
    (:func:`default_backend` when None): the torch counterpart of XLA
    choosing it."""
    if is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError("initialize_runtime: pass coordinator_address, num_processes and process_id "
                             "together, or none of them (env:// from torch.distributed.run)")
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        url = "env://"
        world, rank = int(os.environ.get("WORLD_SIZE", "1")), int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend or default_backend(), init_method=url, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``, 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device() -> torch.device:
    """A rank's default card: ``cuda:{LOCAL_RANK}``. Raises when there is no
    card or no card of that index (an explicit ``device`` wins over this,
    which is how two ranks share one card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU explicitly")
    idx = local_rank()
    if idx >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {idx} has no card: this machine has {torch.cuda.device_count()}")
    return torch.device("cuda", idx)


def process_info() -> dict:
    """This rank's coordinates in the job: {process_index, process_count,
    local_devices, global_devices}; one card a rank."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if is_initialized() else (0, 1)
    return {"process_index": rank, "process_count": world, "local_devices": 1, "global_devices": world}
