"""The world of processes and every collective the port makes, in one place.

JAX drives a whole mesh from one process; PyTorch runs one process per
shard. A process joins the world once (`init_world`), and everything the
parallel paths exchange goes through the functions here, so what a backend
can and cannot do is handled in this module alone.

Devices and the backend, by one rule (logged when the world starts):
- `device="cuda"` (no index) gives each rank its own card, cuda:LOCAL_RANK,
  and the world uses NCCL;
- a named device (`cuda:0`, `cpu`) is the device of every rank, and the world
  uses gloo: on the CPU because NCCL has no CPU path, on a shared card
  because NCCL refuses two ranks on one device.
The backend follows from the layout before the world starts; it is never a
switch made after a failure.

What gloo takes for CUDA tensors (torch 2.11, two ranks on one H100,
`python -m blp_tpu_torch.tools.gloo_probe`; README.md): all_reduce (float and int32), all_gather,
all_gather_into_tensor, broadcast and reduce_scatter_tensor run on CUDA
tensors and give the right values; send, recv, isend and irecv do not — the
process aborts in gloo's TCP transport ("writev: Bad address"), which is
handed the device pointer. So `send` and `recv` stage a CUDA tensor through
host memory under gloo. gloo stages CUDA tensors through the host itself,
so each collective costs a copy each way (PERF.md has its times).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from blp_tpu_torch.utils import get_logger

#: How long a collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for an index-less "cuda", else
    the named device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def backend_for(device) -> str:
    """NCCL where each rank has its own card (an index-less "cuda"); gloo
    on the CPU and where every rank names one device."""
    dev = torch.device(device)
    return "nccl" if dev.type == "cuda" and dev.index is None else "gloo"


def init_world(device="cuda", *, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> torch.device:
    """Join the world of processes (a no-op when it is already up) and
    return this rank's device.

    Without `init_method` the world comes from the environment
    `torch.distributed.run` sets (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE); a process started alone, without that environment, stays
    a world of one and starts no group.
    """
    dev = rank_device(device)
    if dev.type == "cuda":
        # Set and initialise the device first: a DeviceMesh picks
        # cuda:LOCAL_RANK itself on an uninitialised device, which is wrong
        # where ranks share a card.
        torch.cuda.set_device(dev)
        torch.cuda.init()
    if dist.is_initialized():
        return dev
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return dev
    backend = backend_for(device)
    dist.init_process_group(
        backend, init_method=init_method, timeout=TIMEOUT,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    get_logger().info(
        f"world: rank {dist.get_rank()} of {dist.get_world_size()} on {dev}, "
        f"backend {backend} ("
        + ("each rank its own card" if backend == "nccl" else
           "every rank on the named device" if dev.type == "cuda" else "CPU")
        + ")")
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this process sees it: the group of ranks along
    it, their global ranks in axis order, and this process's place."""
    group: object
    ranks: tuple[int, ...]
    rank: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @staticmethod
    def of(mesh, name: str) -> "Axis":
        group = mesh.get_group(name)
        return Axis(group, tuple(dist.get_process_group_ranks(group)),
                    mesh.get_local_rank(name))


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def barrier() -> None:
    """Wait for every rank of the world (a no-op in a world of one)."""
    if dist.is_initialized():
        dist.barrier()


def all_reduce(t: torch.Tensor, axis: Axis | None = None) -> torch.Tensor:
    """Sum `t` over the axis (every rank when None), in place; returns t."""
    group = None if axis is None else axis.group
    if axis is None or axis.size > 1:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_tree(tree, axis: Axis | None = None):
    """Every leaf of a tree of tensors summed over the axis, in one
    collective over a flat buffer; returns a new tree."""
    from blp_tpu_torch.checkpoint import tree_leaves, tree_unflatten

    leaves = tree_leaves(tree)
    flat = all_reduce(torch.cat([x.reshape(-1) for x in leaves]), axis)
    out = []
    for x in leaves:
        out.append(flat[:x.numel()].view_as(x))
        flat = flat[x.numel():]
    return tree_unflatten(tree, out)


def all_gather(t: torch.Tensor, axis: Axis | None = None) -> list[torch.Tensor]:
    """Every rank's `t` (equal shapes), in axis order."""
    group = None if axis is None else axis.group
    n = world_size() if axis is None else axis.size
    if n == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src: int, axis: Axis | None = None) -> torch.Tensor:
    """`t` from global rank `src` to every rank of the axis, in place."""
    if axis is None or axis.size > 1:
        dist.broadcast(t, src=src, group=None if axis is None else axis.group)
    return t


def send(t: torch.Tensor, dst: int) -> None:
    """Send `t` to global rank `dst` (gloo: through host memory for a CUDA
    tensor; gloo's send has no CUDA path)."""
    if _via_host(t, None):
        t = t.cpu()
    dist.send(t.contiguous(), dst)


def recv(t: torch.Tensor, src: int) -> torch.Tensor:
    """Receive into `t` from global rank `src`; returns t."""
    if _via_host(t, None):
        host = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(host, src)
        t.copy_(host)
    else:
        dist.recv(t, src)
    return t


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, concatenated in axis order. Backward:
    this rank's slice of the incoming gradient, unsummed. That is the exact
    gradient of the rows when every rank computes the same function of the
    gathered tensor (the replicated loss of the data-parallel step), so the
    ranks' gradients need no rescaling."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.rows, ctx.rank = x.shape[0], axis.rank
        return torch.cat(all_gather(x, axis), dim=0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """`x` of every rank of the axis stacked on dim 0 (see _GatherRows)."""
    if axis is None or axis.size == 1:
        return x
    return _GatherRows.apply(x, axis)


class _CopyTo(torch.autograd.Function):
    """Megatron's f at a column-parallel input: identity forward, the
    gradient summed over the axis in the backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g after a row-parallel product: the partial products
    summed over the axis forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _ReduceFrom.apply(x, axis)
