"""Process-group start-up and the multi-host mesh (port of
``das3r_tpu/parallel/multihost.py``).

Every process runs the same program. ``initialize_distributed`` joins
them (the reference's ``init_distributed_mode``, training.py:83,174): from
the ``env://`` variables that ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_WORLD_SIZE``), or from
the explicit arguments. ``global_mesh`` lays the (data, gauss, tile) mesh
over all ranks with ``data`` across hosts, where a host's ranks stand for
JAX's devices of a host.

    torchrun --nproc_per_node 2 script.py     # script: initialize_distributed()
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from das3r_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh, mesh_shape


def choose_backend(device, local_world_size: int) -> str:
    """NCCL where each rank has a card of its own; gloo on the CPU and
    where ranks share a card (NCCL refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    if local_world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> str:
    """``init_process_group`` over every process; returns the backend.

    With no arguments it reads ``torchrun``'s ``env://`` variables. With
    ``coordinator_address`` (``host:port``, or a URL such as
    ``file:///path`` or ``tcp://host:port``) it takes ``num_processes``
    and ``process_id`` as the world size and the rank. The backend follows
    ``device`` (default: CUDA where it is available, else the CPU) and
    ``choose_backend``; it is printed, and a failure raises: nothing is
    retried on another backend. A CUDA rank's device is
    ``cuda:<local rank mod the cards>``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if coordinator_address is None:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        world, rank = num_processes, process_id
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    backend = choose_backend(device, local_world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    print(f"initialize_distributed: rank {rank} of {world}, backend "
          f"{backend}, device {device}", flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return backend


def global_mesh(data: int | None = None, tile: int | None = None,
                gauss: int | None = None, world_size: int | None = None,
                local_world_size: int | None = None) -> Mesh:
    """The (data, gauss, tile) mesh over all ranks, ``data`` across hosts
    (its all-reduce is one message a step) and ``gauss`` x ``tile`` within
    a host (they communicate inside every render).

    Defaults, as in JAX: data = the host count; gauss absorbs the
    per-host remainder; tile = 1. Pass any two to pin the third. The
    hosts are ``world / local world`` (``LOCAL_WORLD_SIZE``, or
    ``local_world_size``; one host without either). With ``world_size``
    the mesh is made without a process group, as ``make_mesh`` does."""
    n = (world_size if world_size is not None
         else dist.get_world_size() if dist.is_initialized() else 1)
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    n_hosts = max(n // local_world_size, 1)
    per_host = n // n_hosts
    if data is None:
        known = (gauss or 1) * (tile or 1)
        data = n_hosts if n % (n_hosts * known) == 0 else n // known
    if gauss is None:
        gauss = n // (data * tile) if tile is not None else n // data
    if tile is None:
        tile = n // (data * gauss)
    shape = mesh_shape(n, data, tile, gauss)
    inner = shape["gauss"] * shape["tile"]
    if per_host % inner and inner % per_host:
        raise ValueError("gauss * tile should tile a host's ranks so those "
                         f"axes stay inside a host: per host {per_host}, "
                         f"gauss {shape['gauss']}, tile {shape['tile']}")
    return make_mesh(**{a: shape[a] for a in AXES}, world_size=world_size)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
