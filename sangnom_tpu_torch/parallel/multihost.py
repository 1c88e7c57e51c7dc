"""Multi-process frame sharding over ``torch.distributed``.

The reference scales across threads of ONE host: ``MT_MULTI_INSTANCE``
(reference src/SangNom2.h:63-66) runs N filter instances with private
scratch, zero shared state, one frame each.  The filter is a stateless
per-frame transform, so frame sharding across processes (one per host, or
several on one host) is pure data parallelism: frames never cross a
process.  The only traffic is one all-gather of the processes' frame counts
a call (`COLLECTIVES` counts it).  Width-sharding halos stay inside a
process: `multihost_mesh` keeps every ``space`` row of the mesh on one
process's devices.  A row may span several of them (``local_devices=
["cuda:0", "cuda:1"]``, ``space=2``: the route across devices,
parallel.cross_device) but never two processes.

Usage (one process per host or card, every process runs the same code)::

    initialize_distributed("host:port", num_processes, process_id)
    mesh = multihost_mesh(local_devices=["cuda:0"])
    out_local = sangnom2_multihost(clip_local, mesh, order=1, dh=True)

where ``clip_local`` is this process's shard of frames and ``out_local``
the matching shard of the output; no process holds the whole clip.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sangnom_tpu_torch.core.clip import Clip
from sangnom_tpu_torch.parallel.sharding import Mesh, default_mesh, sangnom2_sharded

# Collectives this module has run in this process: one in
# `multihost_mesh`, one a `sangnom2_multihost` call (the frame counts).
COLLECTIVES = 0


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    backend: str = "gloo",
    timeout_s: Optional[float] = None,
) -> None:
    """Join the process group: ``init_process_group`` at
    ``tcp://coordinator_address`` ("host:port"; process 0 listens there)
    with this world size and rank.  ``backend`` "gloo" runs the frame-count
    all-gather on the host (the card needs no collective); "nccl" works too.
    """
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)


def _all_gather_ints(value: int) -> list[int]:
    """One all-gather of an int64 from every process (counted)."""
    global COLLECTIVES
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mine = torch.tensor([value], dtype=torch.int64, device=dev)
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(got, mine)
    COLLECTIVES += 1
    return [int(t.item()) for t in got]


def multihost_mesh(data: Optional[int] = None, space: int = 1,
                   local_devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'space') mesh over EVERY process's local devices.

    ``local_devices`` are this process's devices (default: every CUDA
    device); a device may repeat, as in `default_mesh`.  The global device
    list is process-contiguous (rank 0's devices first), so the mesh's
    rows (``data``) spread over processes and each ``space`` row stays
    inside one process.  The mesh's ``processes`` grid names each slot's
    rank.  One collective: the processes' device counts."""
    if local_devices is None:
        local_devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    local_devices = [torch.device(d) for d in local_devices]
    counts = _all_gather_ints(len(local_devices))
    n_proc = len(counts)
    n_dev = sum(counts)
    if len(set(counts)) != 1:
        raise ValueError(
            f"uneven device counts: {n_dev} devices over "
            f"{n_proc} processes"
        )
    d_local = counts[0]
    if space > 1 and d_local % space:
        raise ValueError(
            f"space={space} does not divide the {d_local} local devices of "
            "each process; halo exchange would cross the DCN"
        )
    # other processes' slots carry this process's device names: a process
    # only ever runs its own rows
    mesh = default_mesh(data, space, local_devices * n_proc)
    owners = np.repeat(np.arange(n_proc), d_local)[: mesh.devices.size]
    return Mesh(mesh.devices, mesh.axis_names,
                processes=owners.reshape(mesh.devices.shape))


def _local_mesh(mesh: Mesh, data_axis: str, rank: int) -> Mesh:
    """The rows of ``mesh`` (along ``data_axis``) that process ``rank`` owns."""
    devices, owners = mesh.devices, mesh.processes
    if mesh.axis_names.index(data_axis) != 0:
        devices, owners = devices.T, owners.T
    rows = [i for i in range(devices.shape[0]) if (owners[i] == rank).all()]
    names = (data_axis,) + tuple(a for a in mesh.axis_names if a != data_axis)
    return Mesh(devices[rows], names)


def sangnom2_multihost(
    clip: Clip,
    mesh: Mesh,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    threads: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    opt: int = -1,
    data_axis: str = "data",
    space_axis: Optional[str] = None,
) -> Clip:
    """SangNom2 over a multi-process mesh (every process calls it).

    ``clip`` is this process's LOCAL shard of the global clip; processes
    may hold different frame counts.  One all-gather of the counts gives
    every process the same padded share; each process runs
    `sangnom2_sharded` on its own rows of ``mesh`` and returns its own
    frames, trimmed, on the clip's device.  Parameter surface and numerics
    are those of `sangnom_tpu_torch.sangnom2` (reference
    src/SangNom2.cpp:399-435)."""
    n_proc = dist.get_world_size()
    n_data = mesh.shape[data_axis]
    if n_data % n_proc:
        raise ValueError(
            f"data axis ({n_data}) must be a multiple of the process "
            f"count ({n_proc}) for process-contiguous frame shards"
        )
    if mesh.processes is None:
        raise ValueError("sangnom2_multihost needs a mesh from multihost_mesh")
    d_per_proc = n_data // n_proc

    n_local = clip.num_frames
    counts = _all_gather_ints(n_local)
    # every process pads to the same share, so every process runs the same
    # frame count on each of its rows
    per_proc = -(-max(counts) // d_per_proc) * d_per_proc
    pad = per_proc - n_local

    planes = []
    for p in clip.planes:
        if pad:
            zeros = torch.zeros((pad,) + p.shape[1:], dtype=torch.int16
                                if p.dtype == torch.uint16 else p.dtype, device=p.device)
            p = torch.cat([p, zeros.view(p.dtype)])
        planes.append(p)
    parity = np.concatenate([clip.parity_array(), np.zeros(pad, dtype=bool)])
    local = Clip(planes, clip.format, parity=parity, tff=clip.tff, props=clip.props)
    out = sangnom2_sharded(
        local, _local_mesh(mesh, data_axis, dist.get_rank()), order, aa, aac,
        threads, dh, luma, chroma, opt, data_axis=data_axis,
        space_axis=space_axis,
    )
    return Clip([p[:n_local] for p in out.planes], clip.format,
                parity=clip.parity, tff=clip.tff, props=clip.props)
