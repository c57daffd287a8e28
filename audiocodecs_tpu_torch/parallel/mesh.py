"""Process group, device mesh and batch placement on ``torch.distributed``.

Counterpart of ``audiocodecs_tpu/parallel/mesh.py``, which builds one
``jax.sharding.Mesh`` with ``(data, model)`` axes and lets GSPMD insert the
collectives. Here a rank is one process and one device, the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``("data", "model")``, and ``("data", "seq", "model")`` for sequence
parallelism), and every layout is explicit: the parallel steps of
:mod:`.train`, :mod:`.moe` and :mod:`.pipeline` call the collectives of
:mod:`.comm` themselves.

The backend is chosen by device: NCCL for the card, gloo for the CPU. A
mesh asks for one rank a device: on CUDA a rank per card, and nothing falls
back to the CPU or to a smaller world when that is not met.
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "axis_group",
           "axis_index", "axis_ranks", "axis_size", "backend_for",
           "data_parallel", "data_sharding", "init_distributed",
           "is_main_process", "launched_world_size", "local_batch_slice",
           "make_mesh",
           "replicated", "shard_batch", "spawn_ranks"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Join the process group of this run (the reference's
    ``init_distributed``, ``train_asr.py:213-214``'s ``ddp_init_group``).

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK`` of the
    environment (``torchrun`` sets them, with ``MASTER_ADDR`` and
    ``MASTER_PORT`` for its store); ``init_method`` defaults to ``env://``.
    Two cases are benign and tolerated, as in the reference: a group that is
    already initialised (a no-op), and a single process with no launcher in
    the environment, which gets a one-rank group over an in-process store.
    Any other failure to join raises: a rank that carried on alone would
    train on the whole data and overwrite the others' checkpoints.

    On CUDA the rank's card is ``LOCAL_RANK`` (else the rank) and must
    exist. ``timeout_s`` bounds each collective's wait (the backend's
    default when None)."""
    if dist.is_initialized():
        return
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    device = torch.device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"rank {rank} needs card {local} but this machine has "
                f"{torch.cuda.device_count()}: one rank a card")
        torch.cuda.set_device(local)
    backend = backend_for(device)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in env:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
        return
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)


def launched_world_size() -> int:
    """Ranks of the initialised process group, else ``WORLD_SIZE`` of the
    launcher's environment (1 without one)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
              device="cuda", seq_parallel: int = 1):
    """A ``DeviceMesh`` over ``n_devices`` ranks (the whole process group
    when None, which is joined first if need be): ``(data, model)`` of
    shape ``(n / mp, mp)``, or with three ``axis_names`` ``(data, seq,
    model)`` of shape ``(n / (sp·mp), sp, mp)``. Model-parallel ranks are
    the innermost axis, as in the reference.

    Raises when ``n_devices`` asks for more cards than CUDA has, when it
    differs from the process group's size (one rank a device), or when
    an axis does not divide it."""
    device = torch.device(device)
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if n_devices is not None and n_devices > have:
            raise ValueError(f"requested {n_devices} devices but backend "
                             f"cuda has only {have}")
    world = launched_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"requested {n} devices but the process group has "
                         f"{world} ranks: a mesh spans every rank, one a "
                         f"device")
    names = tuple(axis_names)
    inner = model_parallel * (seq_parallel if len(names) == 3 else 1)
    if n % inner:
        raise ValueError(f"{n} devices not divisible by mp={model_parallel}"
                         + (f" x sp={seq_parallel}" if len(names) == 3
                            else ""))
    init_distributed(device)
    shape = ((n // inner, seq_parallel, model_parallel) if len(names) == 3
             else (n // model_parallel, model_parallel))
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def axis_size(mesh, name: str) -> int:
    """Ranks along mesh axis ``name``; 1 when the mesh has no such axis."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 without the axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of this rank's line along ``name``, or None when
    the line is this rank alone (no collective is needed on it)."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def axis_ranks(mesh, name: str) -> list:
    """The global ranks of this rank's line along ``name``, by coordinate."""
    if axis_size(mesh, name) == 1:
        return [dist.get_rank() if dist.is_initialized() else 0]
    return dist.get_process_group_ranks(mesh.get_group(name))


def data_sharding(mesh) -> list:
    """The placement of a batch: axis 0 split over ``data``, replicated on
    every other mesh axis (``torch.distributed.tensor`` placements, one a
    mesh axis)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if n == DATA_AXIS else Replicate()
            for n in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    """Every mesh axis replicated."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def _rows(x, mesh):
    n, i = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not divide by "
                         f"the data axis of {n}")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def shard_batch(mesh, batch, device=None):
    """This rank's rows of every leaf of ``batch`` (dicts, lists, tuples of
    arrays or tensors: the global batch, the same on every rank), as
    contiguous tensors on ``device`` (the mesh's when None). Raises when the
    rows do not divide by the data axis, as the reference's sharding
    does."""
    device = device or (mesh.device_type if mesh.device_type != "cuda"
                        else torch.device("cuda",
                                          torch.cuda.current_device()))
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, device) for v in batch)
    return _rows(torch.as_tensor(batch), mesh).to(device).contiguous()


def is_main_process() -> bool:
    """Rank 0 of the initialised process group (checkpoint and log writes,
    the reference's ``if_main_process``); true without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(global_batch: int, mesh=None) -> slice:
    """This rank's rows of a global batch: its coordinate on ``data`` of
    ``mesh``, or of the whole process group without one."""
    if mesh is None:
        n = launched_world_size()
        i = dist.get_rank() if dist.is_initialized() else 0
    else:
        n, i = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def data_parallel(fn, mesh, *batch):
    """``fn`` on this rank's rows of each global array of ``batch``, and its
    outputs (a tensor or a tuple of tensors) all-gathered over ``data`` in
    row order: data-parallel serving with replicated params, the
    reference's jit of ``fn`` on a batch-sharded input."""
    from audiocodecs_tpu_torch.parallel.comm import all_gather_cat

    out = fn(*shard_batch(mesh, batch))
    group = axis_group(mesh, DATA_AXIS)
    if isinstance(out, tuple):
        return tuple(all_gather_cat(o.contiguous(), group, 0) for o in out)
    return all_gather_cat(out.contiguous(), group, 0)


def _rank_main(rank, n, tmp, device_type, fn, args):
    torch.set_num_threads(1)
    init_distributed(device_type, init_method=f"file://{tmp}/store",
                     world_size=n, rank=rank, timeout_s=300.0)
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn, n_ranks: int, *args, device="cpu") -> list:
    """``fn(rank, *args)`` in ``n_ranks`` fresh processes joined in one
    process group (gloo on the CPU, NCCL on CUDA with rank r on card r),
    whose store is a file in a temporary directory, so that no TCP port is
    taken and parallel runs cannot collide. Each process runs torch on one
    intra-op thread, and a collective waits at most 300 s. Returns the
    ranks' return values (picklable) in rank order; a rank that raises
    stops them all and re-raises here. On CUDA ``n_ranks`` must not
    exceed the card count: nothing falls back to the CPU."""
    import tempfile

    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_ranks > have:
            raise ValueError(f"{n_ranks} ranks need {n_ranks} cards, one a "
                             f"rank; this machine has {have}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=n_ranks, join=True,
                 args=(n_ranks, tmp, device_type, fn, args))
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
