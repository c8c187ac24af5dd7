"""Process-group initialisation: one process per device.

Port of ``nequip_tpu/parallel/distributed.py`` in PyTorch's idiom: where
JAX connects one controller per host and then sees every device, here each
device has its own process (a rank), as ``torchrun`` or SLURM start them::

    torchrun --nproc-per-node 4 -m nequip_tpu_torch.scripts.train -cn cfg ++trainer.devices=4

    from nequip_tpu_torch.parallel import init_distributed
    init_distributed()      # no-op (False) in a single process

Without arguments ``init_distributed`` reads torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``, with
``MASTER_ADDR``/``MASTER_PORT``).  Each rank's device is
``cuda:{LOCAL_RANK}`` unless the caller names one (the CPU, as the tests
do).  The backend is NCCL on CUDA and gloo on the CPU; gloo on CUDA only
when asked for by name.  NCCL cannot put two ranks on one card, so
``init_distributed`` refuses that, naming ``backend="gloo"``, instead of
switching backend behind the caller's back.

After it, every rank holds its device in ``current_device()``, and every
mesh (``parallel.mesh``) spans the ranks.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("nequip_tpu_torch")

_DEVICE: Optional[torch.device] = None


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def current_device(default="cuda") -> torch.device:
    """The device ``init_distributed`` gave this rank, else ``default``."""
    return _DEVICE if _DEVICE is not None else torch.device(default)


def _card_id(device: torch.device) -> str:
    """Which physical card ``device`` is, across the ranks of one job."""
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{socket.gethostname()}:{os.environ.get('CUDA_VISIBLE_DEVICES', '')}:{device.index}"


def init_distributed(
    backend: Optional[str] = None,
    device=None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout: datetime.timedelta = datetime.timedelta(minutes=10),
) -> bool:
    """Initialise the default process group; True if this is a distributed run.

    Explicit arguments win over the environment.  A no-op returning False
    when neither names more than one process and no ``init_method`` is given
    (or the group exists already, returning True).  ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``); ``file://`` and ``tcp://`` work too.
    """
    global _DEVICE
    if dist.is_initialized():
        return True
    rank = rank if rank is not None else _env_int("RANK", "SLURM_PROCID")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE", "SLURM_NTASKS")
    if world_size is None or (world_size <= 1 and init_method is None):
        log.info("single-process run (no multi-process environment detected)")
        return False
    if rank is None and world_size == 1:
        rank = 0
    if rank is None:
        raise ValueError(f"world size {world_size} but no rank: pass rank= or set RANK (torchrun) or SLURM_PROCID")
    local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", local_rank if local_rank is not None else rank)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device {dev} asked for but torch.cuda.is_available() is False; "
                               "pass device='cpu' to run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: {dev} but this process sees {torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend='nccl' needs CUDA devices, but rank {rank} runs on {dev}")

    store, rank, world_size = next(dist.rendezvous(init_method or "env://", rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    if dev.type == "cuda":
        # every rank says which card it has, so a shared card is refused on all ranks alike
        store.set(f"nequip_card/{rank}", _card_id(dev))
        cards = [store.get(f"nequip_card/{r}").decode() for r in range(world_size)]
        if backend == "nccl" and len(set(cards)) < world_size:
            raise RuntimeError(
                f"backend='nccl' with {world_size} ranks on {len(set(cards))} card(s): NCCL cannot run two ranks on "
                "one card; give each rank its own card, or ask for backend='gloo' by name (its collectives copy "
                "through host memory)"
            )
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, timeout=timeout)
    _DEVICE = dev
    log.info(f"torch.distributed initialised: rank {rank} / {world_size} on {dev}, backend {backend}")
    return True


def destroy_distributed() -> None:
    """Tear the default group down (end of a run, or between tests)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
