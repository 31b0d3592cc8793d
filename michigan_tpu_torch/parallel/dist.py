"""Data parallelism over ``torch.distributed``, one process per device: the
port's counterpart of michigan_tpu/parallel/mesh.py.

The JAX package shards the global batch over a mesh's ``data`` axis and
psums inside one SPMD program.  Here each process holds a full replica on
its own device and one slice of every global batch; the replicas stay equal
because they start equal (``check_replicas_identical``), sum the same
collectives and take the same optimizer step:

- sync batch norm all-reduces each norm's (sum, sum of squares, count)
  forward and its two gradient sums backward (``all_reduce_sum`` and
  ops/norms.py), as ``lax.psum`` does and its transpose;
- the trained nets' gradients are averaged after the backward and before
  Adam (``average_gradients``), the JAX package's ``_grad_pmean``;
- the losses are averaged for printing (``mean_over``).

With one process there is no group and nothing here runs a collective, as
the JAX package builds no mesh on one device.  Under --mesh_shape space:N
the processes are one spatial group instead (parallel/spatial.py): no
replicas, each rank a band of rows; ``average_gradients`` and ``mean_over``
then sum (``mean=False``).  A ``Replica`` comes from
torchrun's environment (``replica_from_env``) or from a caller that made
its own group; ``launch`` starts the processes of one host itself.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import socket
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a rank that waits longer than this at a collective raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Replica:
    """This process among the replicas: its group (None with one process),
    rank, world size and device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device

    def is_main(self) -> bool:
        """Rank 0: the one that prints and writes checkpoints and logs."""
        return self.rank == 0


def gpu_id_list(gpu_ids: str) -> List[int]:
    """--gpu_ids '0,1,2' -> [0, 1, 2]; '-1' (the CPU) -> []."""
    ids = [int(s) for s in str(gpu_ids).split(",") if s.strip()]
    return [] if not ids or ids[0] < 0 else ids


def mesh_axes(mesh_shape: str) -> Tuple[int, int]:
    """--mesh_shape -> (data axis size, space axis size): 'data:-1' (every
    process) or 'data:N' -> (-1 or N, 1); 'space:N' or 'data:1,space:N' ->
    (1, N), the ranks one spatial group that trains in row bands
    (parallel/spatial.py).  The data x space grid ('data:M,space:N', M > 1)
    raises NotImplementedError: it is the next slice of spatial training."""
    parts = [p.split(":") for p in mesh_shape.split(",")]
    if any(len(p) != 2 for p in parts) or len({p[0] for p in parts}) != len(parts) or \
            not {p[0] for p in parts} <= {"data", "space"}:
        raise NotImplementedError(
            f"--mesh_shape {mesh_shape}: the ported axes are 'data:-1', 'data:N' (data "
            "parallelism), and 'space:N' or 'data:1,space:N' (spatial sharding of training: "
            "row bands over N ranks); inference runs in row bands through "
            "michigan_tpu_torch.parallel.spatial.make_spatial_infer")
    sizes = {name: int(n) for name, n in parts}
    data, space = sizes.get("data", 1 if "space" in sizes else -1), sizes.get("space", 1)
    if space < 1:
        raise ValueError(f"--mesh_shape {mesh_shape}: the space axis needs a size of at least 1")
    if space > 1 and data != 1:
        raise NotImplementedError(
            f"--mesh_shape {mesh_shape}: the data x space grid (data parallelism over replicas "
            "that each train in row bands) is not ported yet; it is the next slice of spatial "
            "training. Use 'data:N' or 'space:N'")
    return data, space


def data_axis_size(mesh_shape: str) -> int:
    """--mesh_shape 'data:-1' (every process) or 'data:N' -> -1 or N; 1
    under 'space:N' (``mesh_axes``)."""
    return mesh_axes(mesh_shape)[0]


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo for the CPU; no NCCL on a card is an error."""
    if device.type != "cuda":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("data parallelism on CUDA devices needs NCCL, which this torch lacks")
    return "nccl"


def init_group(backend: str, rank: int, world: int, addr: str, port: int,
               device: Optional[torch.device] = None,
               timeout: datetime.timedelta = TIMEOUT) -> dist.ProcessGroup:
    """The default process group of `world` processes at tcp://addr:port,
    with `timeout`; NCCL is bound to `device`."""
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, timeout=timeout,
                            device_id=device if backend == "nccl" else None)
    return dist.group.WORLD


def in_launched_process() -> bool:
    """Whether torchrun (or ``launch``) started this process."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def replica_from_env(gpu_ids: str, mesh_shape: str = "data:-1",
                     timeout: datetime.timedelta = TIMEOUT) -> Replica:
    """This process's Replica from torchrun's environment, its group made
    with `timeout` (NCCL on the card ``--gpu_ids[LOCAL_RANK]``, gloo under
    --gpu_ids -1).  Outside torchrun, or at WORLD_SIZE 1: one process, no
    group, the device of --gpu_ids' first id."""
    ids = gpu_id_list(gpu_ids)
    world = int(os.environ.get("WORLD_SIZE", "1")) if in_launched_process() else 1
    size, space = mesh_axes(mesh_shape)
    if space > 1 and space != world:
        raise ValueError(f"--mesh_shape {mesh_shape} asks for {space} ranks in row bands; "
                         f"{world} processes were started")
    if space == 1 and size not in (-1, world):
        raise ValueError(f"--mesh_shape data:{size} asks for {size} replicas; "
                         f"{world} processes were started")
    if world == 1:
        from michigan_tpu_torch.inference import device_from_gpu_ids

        return Replica(None, 0, 1, device_from_gpu_ids(gpu_ids))
    rank, local = int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    if ids:
        if local >= len(ids):
            raise ValueError(f"local rank {local} has no GPU in --gpu_ids {gpu_ids}: give one "
                             "id for each process of the host")
        check_gpus(ids)
        device = torch.device(f"cuda:{ids[local]}")
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    group = init_group(backend_for(device), rank, world, os.environ["MASTER_ADDR"],
                       int(os.environ["MASTER_PORT"]), device, timeout)
    return Replica(group, rank, world, device)


def check_gpus(ids: Sequence[int]) -> None:
    """Raise unless every id names a CUDA device of this host."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max(ids) >= have:
        raise RuntimeError(f"--gpu_ids {','.join(map(str, ids))} asks for GPU {max(ids)}; "
                           f"this host has {have}")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its backward sums the cotangents over the group
    (the transpose of psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """x summed over `group`, differentiably (lax.psum)."""
    return _AllReduceSum.apply(x, group)


def average_gradients(params: Iterable[torch.Tensor], group: dist.ProcessGroup,
                      bf16: bool = False, mean: bool = True) -> None:
    """Replace each parameter's .grad by its mean over `group` (its sum
    without `mean`: the ranks of one spatial group, whose objectives add up
    to the one process's), all of them in one flattened all-reduce.  With
    `bf16` (--bf16_grad_allreduce) the JAX package's rounding: cast to
    bfloat16, sum and divide in bfloat16, cast back."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if bf16:
        flat = flat.to(torch.bfloat16)
    dist.all_reduce(flat, group=group)
    if mean:
        flat = flat / dist.get_world_size(group)
    flat = flat.to(grads[0].dtype)
    for g, mean_ in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(mean_.view_as(g))


def mean_over(values: Dict[str, torch.Tensor], group: dist.ProcessGroup, mean: bool = True
              ) -> Dict[str, torch.Tensor]:
    """{name: scalar} averaged over `group` (summed without `mean`), in one
    all-reduce."""
    if not values:
        return values
    flat = torch.stack([v.detach().float() for v in values.values()])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    return dict(zip(values, flat.unbind()))


def check_replicas_identical(tensors: Iterable[torch.Tensor], group: dist.ProcessGroup,
                             what: str = "the replicas' state") -> None:
    """Raise on every rank unless each rank's `tensors` equal rank 0's bit
    for bit (float32, bfloat16 and small integers compare exactly as float32),
    by one broadcast from rank 0 and one all-reduce of the verdict."""
    mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = mine.clone()
    dist.broadcast(ref, src=dist.get_global_rank(group, 0), group=group)
    differ = torch.tensor([0.0 if torch.equal(mine, ref) else 1.0], device=mine.device)
    dist.all_reduce(differ, group=group)
    if differ.item():
        raise RuntimeError(f"{what} differs between ranks ({int(differ.item())} of "
                           f"{dist.get_world_size(group)} differ from rank 0)")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn: Callable, args: tuple, env: Dict[str, str]) -> None:
    os.environ.update(env)
    fn(*args)


def launch(fn: Callable, args: tuple, world: int, timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in `world` new processes on this host (spawned;
    `fn` importable), each with torchrun's environment for its rank.  Each
    must exit 0 within `timeout` seconds (None: no limit); the first that
    fails, or the timeout, terminates every rank still running and raises
    RuntimeError."""
    ctx = multiprocessing.get_context("spawn")
    env = {"WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, args, {**env, "RANK": str(r), "LOCAL_RANK": str(r)}))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        running = list(procs)
        while running:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise RuntimeError(f"ranks {[procs.index(p) for p in running]} still running "
                                   f"after {timeout} s")
            for s in multiprocessing.connection.wait([p.sentinel for p in running], left):
                p = next(p for p in running if p.sentinel == s)
                p.join()
                running.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {procs.index(p)} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
