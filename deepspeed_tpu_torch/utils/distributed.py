"""Distributed initialization (port of deepspeed_tpu/utils/distributed.py).

The JAX package's `jax.distributed.initialize` rendezvous becomes
`torch.distributed.init_process_group`: NCCL on CUDA, gloo on the CPU.
The launcher contract is the same: MASTER_ADDR/MASTER_PORT, RANK and
WORLD_SIZE from the environment, with the MPI fallback (OpenMPI/PMI
variables) when no MASTER_ADDR is set. An explicit `init_method` (e.g.
a `file://` path, which needs no free port) and explicit `rank` /
`world_size` take the place of the environment.
"""

import os
from datetime import timedelta

import torch

from deepspeed_tpu_torch.utils.logging import logger


def init_distributed(dist_backend=None, auto_mpi_discovery=True,
                     distributed_port=29500, verbose=True, timeout=None,
                     init_method=None, rank=None, world_size=None):
    """Initialize torch.distributed's default process group. A second
    call logs and returns. `dist_backend` None picks "nccl" when CUDA
    is available and "gloo" otherwise; `timeout` is in seconds."""
    dist = torch.distributed
    if dist.is_initialized():
        if verbose:
            logger.warning("torch.distributed already initialized; "
                           "skipping")
        return
    if auto_mpi_discovery and init_method is None and \
            os.environ.get("MASTER_ADDR") is None and in_mpi_environment():
        mpi_discovery(distributed_port=distributed_port, verbose=verbose)
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", str(distributed_port))
        init_method = f"tcp://{addr}:{port}"
    if dist_backend is None:
        dist_backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    dist.init_process_group(dist_backend, init_method=init_method,
                            rank=rank, world_size=world_size, **kwargs)
    if verbose:
        logger.info(f"Initialized torch.distributed ({dist_backend}): rank "
                    f"{rank}/{world_size}")


def in_mpi_environment():
    return "OMPI_COMM_WORLD_RANK" in os.environ or \
        "PMI_RANK" in os.environ


def mpi_discovery(distributed_port=29500, verbose=True):
    """MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE from an MPI launch's
    environment (OpenMPI/PMI), without mpi4py: the master is 127.0.0.1
    unless MASTER_ADDR is set."""
    rank = os.environ.get("OMPI_COMM_WORLD_RANK",
                          os.environ.get("PMI_RANK", "0"))
    world_size = os.environ.get("OMPI_COMM_WORLD_SIZE",
                                os.environ.get("PMI_SIZE", "1"))
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    os.environ["MASTER_PORT"] = str(distributed_port)
    os.environ["RANK"] = rank
    os.environ["WORLD_SIZE"] = world_size
    os.environ.setdefault("LOCAL_RANK",
                          os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", "0"))
    if verbose:
        logger.info(f"MPI discovery: rank={rank} world_size={world_size} "
                    f"master_addr={os.environ['MASTER_ADDR']} "
                    f"master_port={distributed_port}")


def get_rank():
    """This process's rank in the default process group (0 without
    one): the JAX package's `jax.process_index()`."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_world_size():
    """The default process group's size (1 without one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
