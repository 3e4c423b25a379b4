"""Device meshes and process groups: data parallelism over targets and
samples, residue-axis (seq) sharding of one target's pair trunk.

Counterpart of ``dmpfold2_tpu/parallel/mesh.py`` in PyTorch's idiom: explicit
``torch.device``s, one process per GPU for multi-process runs, and
``torch.distributed`` collectives (NCCL on CUDA, gloo on the CPU).

  * :class:`Mesh` is a ``(data, seq)`` grid of this process's devices and the
    process group's size and rank. The global ``data`` axis has
    ``world_size x`` the local rows; process ``r`` owns the global data shards
    ``r * n_local .. (r + 1) * n_local - 1``. A device may appear more than
    once: replicas on one card (or on the CPU), each shard with its own
    worker thread and stream.
  * ``seq``: each data shard is a row of ``n_seq`` devices, over which one
    target's pair trunk is split by rows (``parallel/sharding.py``). The row
    is driven by one process, from one thread per batch in flight, without
    ``torch.distributed``; its first device (``local_devices``) runs the rest
    of the network. In a process group each process holds ``n_local x
    n_seq`` cards, from its local rank times that.
  * :func:`initialize_distributed` joins the process group;
    :func:`owned_batch_indices` says which batch slots this process folds or
    trains on; :func:`replicate_result` all-gathers per-process results
    through the host, so that every process holds every result.

Collectives are issued from the caller's thread, in the same order on every
process; worker threads never issue one.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch
import torch.distributed as dist

# a lost peer fails a collective after this long instead of hanging the group
TIMEOUT_S = 600.0


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, device=None,
                           backend: str | None = None,
                           devices_per_process: int = 1) -> torch.device:
    """Join the process group; call once per process before building a mesh.
    Returns this process's device.

    With ``coordinator`` ("HOST:PORT"), ``num_processes`` and ``process_id``
    the group meets at ``tcp://HOST:PORT``; without them it reads the
    ``env://`` variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). ``device`` defaults to ``cuda``: the first of
    the local rank's ``devices_per_process`` cards (card ``LOCAL_RANK x
    devices_per_process``, ``LOCAL_RANK`` else ``process_id``, modulo the
    visible cards), made current before the first collective. The backend is
    ``nccl`` for a CUDA device and ``gloo`` for the CPU; ``backend``
    overrides that choice (gloo on a card is how two ranks share one GPU,
    which NCCL refuses). Nothing switches backend after a failure.
    """
    from ..engine.fold import resolve_device

    dev = resolve_device(device)
    explicit = (num_processes, process_id)
    if coordinator is not None and None in explicit:
        raise ValueError("a coordinator needs num_processes and process_id")
    if coordinator is None and explicit != (None, None):
        raise ValueError("num_processes and process_id apply only with a coordinator")
    if dev.type == "cuda" and dev.index is None:
        if "LOCAL_RANK" in os.environ:
            local = int(os.environ["LOCAL_RANK"])
        else:
            local = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        dev = torch.device("cuda", local * devices_per_process % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
                  timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if coordinator is not None:
        kwargs.update(init_method=f"tcp://{coordinator}", world_size=int(num_processes),
                      rank=int(process_id))
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    return dev


@dataclass(frozen=True)
class Mesh:
    """This process's ``(n_local_data, n_seq)`` grid of devices in a group of
    ``world_size`` processes; ``shape`` is the global one."""

    devices: tuple  # tuple of rows, one per local data shard, each a tuple of n_seq devices
    world_size: int = 1
    rank: int = 0
    axis_names: ClassVar[tuple] = ("data", "seq")

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def n_data(self) -> int:
        return self.world_size * self.n_local

    @property
    def n_seq(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "seq": self.n_seq}

    @property
    def local_devices(self) -> list:
        """The first device of each local data shard's row, in shard order."""
        return [row[0] for row in self.devices]

    @property
    def first_shard(self) -> int:
        """Global data-shard index of this process's first shard."""
        return self.rank * self.n_local


def _local_count(n_data: int | None, world_size: int) -> int:
    """Data shards per process in a group (one when ``n_data`` is open)."""
    return 1 if n_data is None else max(n_data // world_size, 1)


def make_mesh(n_data: int | None = None, n_seq: int = 1, devices=None) -> Mesh:
    """A ``(n_data, n_seq)`` mesh over ``devices`` (this process's, row after
    row; default: every visible CUDA device, or, in a process group, the
    ``n_local x n_seq`` cards from the current one on).

    ``n_data`` counts the whole group's data shards (default: as many rows
    of ``n_seq`` as every process's devices fill) and must be a multiple of
    the group's size. A device may repeat: ``["cuda:0"] * 2`` is two seq
    shards on one card, ``["cpu"] * n`` shards on the CPU. Too few devices
    raise ``ValueError``.
    """
    world_size, rank = world()
    if n_seq < 1:
        raise ValueError(f"mesh seq axis must be >= 1 (got {n_seq})")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > 1:
            first = torch.cuda.current_device() if count else 0
            devices = [torch.device("cuda", first + i)
                       for i in range(_local_count(n_data, world_size) * n_seq)
                       if first + i < count]
        else:
            devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    available = world_size * (len(devices) // n_seq)
    if n_data is None:
        n_data = available
    if n_data < 1 or n_data > available:
        raise ValueError(
            f"mesh {n_data}x{n_seq} needs {max(n_data, 1) * n_seq} "
            f"devices but only {world_size * len(devices)} are available")
    if n_data % world_size:
        raise ValueError(f"mesh data axis {n_data} is not a multiple of the {world_size} "
                         f"processes: each process holds the same number of shards")
    n_local = n_data // world_size
    grid = tuple(tuple(devices[i * n_seq:(i + 1) * n_seq]) for i in range(n_local))
    return Mesh(grid, world_size, rank)


def mesh_shape(spec: str) -> tuple[int | None, int]:
    """``--mesh DATA[xSEQ]|auto`` -> (n_data or None for auto, n_seq)."""
    if spec == "auto":
        return None, 1
    data, _, seq = spec.partition("x")
    return int(data), int(seq or 1)


def parse_mesh(spec: str, device=None) -> Mesh:
    """The CLI's ``--mesh DATA[xSEQ]|auto``. On the CPU (``device`` cpu) the
    shards are replicas on the CPU (``auto``: one data shard)."""
    n_data, n_seq = mesh_shape(spec)
    devices = None
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * (_local_count(n_data, world()[0]) * n_seq)
    return make_mesh(n_data, n_seq, devices)


def owned_batch_indices(mesh: Mesh, batch: int) -> set[int]:
    """Batch slots (of ``batch``, a multiple of the data axis) whose shards
    lie on this process's devices."""
    per = batch // mesh.n_data
    start = mesh.first_shard * per
    return set(range(start, start + mesh.n_local * per))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _concat(parts: list):
    first = parts[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return tuple(_concat([p[i] for p in parts]) for i in range(len(first)))
    return [item for p in parts for item in p]


def replicate_result(local):
    """Every process's ``local`` (an array, a list, or a dict or tuple of
    them, holding this process's batch slots in order), concatenated in rank
    order, on every process. Tensors come back as numpy arrays. No-op in a
    single process.

    Goes through the host (``all_gather_object``): gloo has no all-gather of
    CUDA tensors, and results are fetched to the host anyway. A collective:
    every process calls it, from its main thread.
    """
    world_size, _ = world()
    if world_size == 1:
        return local
    parts = [None] * world_size
    dist.all_gather_object(parts, _host(local))
    return _concat(parts)
