"""Several-process startup on ``torch.distributed``.

The reference has no distributed communication at all: a shell sweep is its
scheduler and CSV files its collective.  Here several processes form one
SPMD program: every process calls :func:`init_distributed` before building a
mesh (``parallel/mesh.py``); the same sharded code (``parallel/fer.py``,
``attack.py``, ``qary.py``) then spans the processes, each decoding its rows
on its own device, with the statistics reduced by the process group's
collectives.

One process a rank.  A rank's device is ``cuda:{LOCAL_RANK % device_count}``,
so ranks of one host spread over its cards.  The process-group backend is
NCCL for CUDA devices and gloo for the CPU unless ``backend`` names one:
NCCL refuses two ranks on one card, so a world of several ranks on one card
passes ``backend="gloo"`` (the collectives then run on the host,
``parallel/mesh.py``).
"""

import logging
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")


def rank_device(device="cuda"):
    """This process's device: ``device`` as given when it names an index or is
    the CPU, else ``cuda:{LOCAL_RANK % device_count}``; raises when a CUDA
    device is asked for and there is none."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return device


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, device="cuda",
                     backend=None):
    """Join (or start) the process group; returns ``(rank, world_size)``.

    The rendezvous comes from the arguments, else from the variables
    ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  ``coordinator_address`` is ``host:port`` (TCP) or a URL
    such as ``file:///path``.  A single process with no address asked for is
    a no-op, ``(0, 1)``, as in the JAX package; an already initialised group
    is returned as it is.  ``backend``: ``"nccl"`` (CUDA devices only) or
    ``"gloo"``; by default NCCL on a CUDA device and gloo on the CPU.  On a
    CUDA device the rank's card (:func:`rank_device`) becomes the current
    device.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    address = coordinator_address
    if address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if address is None:
        if world != 1:
            raise ValueError(f"a world of {world} processes needs a coordinator address")
        return 0, 1
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown process-group backend {backend!r}; expected one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    logger.info(f"distributed init: rank {rank}/{world} over {backend} on {dev}")
    return rank, world
