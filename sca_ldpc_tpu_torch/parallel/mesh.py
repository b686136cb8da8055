"""The ranks of a process group as a ``(data, model)`` mesh.

Counterpart of the JAX package's ``parallel/mesh.py``.  There a mesh is a
grid of devices that XLA shards arrays over; here each rank is one process
on one device (``parallel/distributed.py``), and a :class:`Mesh` holds what a
sharded function needs of the group: the shape ``{"data": d, "model": m}``,
this rank's index and device, and the collectives.  As in the JAX package
the batch (or instance) axis is split over both axes together, rank ``r``
holding the ``r``-th equal block of rows (:meth:`Mesh.rows`); no function
splits a code's N.

Without an initialised process group the mesh is the world of one.  On a
gloo group the collectives run on the host (gloo does not gather CUDA
tensors), on an NCCL group on the device.
"""

import torch
import torch.distributed as dist

from .distributed import rank_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def shard_rows(n, rank, world):
    """Rank ``rank``'s rows of a leading axis of ``n`` split over ``world``
    ranks (``n`` a multiple of ``world``)."""
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


class Mesh:
    """A ``(data, model)`` mesh over ``data * model`` ranks of ``group``
    (``None``: the world of one, without a process group; a group of one
    rank still runs its collectives).  ``rank`` is this process's index in
    it."""

    def __init__(self, data, model, rank, device, group=None):
        self.shape = {"data": int(data), "model": int(model)}
        self.size = self.shape["data"] * self.shape["model"]
        self.rank = int(rank)
        self.device = torch.device(device)
        self.group = group
        if group is None and self.size != 1:
            raise ValueError(f"a mesh of {self.size} ranks needs a process group")

    def __repr__(self):
        return f"Mesh(shape={self.shape}, rank={self.rank}, device={self.device})"

    def rows(self, n):
        """This rank's rows of a leading axis of ``n``: the JAX package's
        ``data_sharding`` of the batch."""
        return shard_rows(n, self.rank, self.size)

    def _on_host(self):
        return dist.get_backend(self.group) == "gloo"

    def all_reduce(self, x, op="sum"):
        """``x`` reduced over the mesh (``op``: ``"sum"``, ``"max"`` or
        ``"min"``), on ``x``'s device."""
        if self.group is None:
            return x
        y = x.cpu() if self._on_host() else x
        y = y.clone()
        dist.all_reduce(y, _OPS[op], group=self.group)
        return y.to(x.device)

    def all_gather(self, x):
        """Every rank's ``x`` concatenated along axis 0 in rank order, on
        ``x``'s device."""
        if self.group is None:
            return x
        y = (x.cpu() if self._on_host() else x).contiguous()
        y = y.to(torch.uint8) if x.dtype == torch.bool else y
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts).to(x.device, x.dtype)

    def check_same(self, values, what):
        """Raise on every rank unless every rank passed the same integer
        ``values`` (an SPMD step whose ranks disagree must stop, not hang in
        a collective of another shape)."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self.device)
        lo, hi = self.all_reduce(t, "min"), self.all_reduce(t, "max")
        if not torch.equal(lo, hi):
            raise RuntimeError(f"the ranks disagree on {what}: min {lo.tolist()} max {hi.tolist()}")


def make_mesh(data=None, model=1, ranks=None, device="cuda"):
    """Mesh over ``(data, model)``; ``data=None`` takes every rank left.

    ``ranks``: the global ranks of the mesh (default: the whole world); every
    process of the world calls ``make_mesh`` with the same ``ranks``, as
    ``torch.distributed.new_group`` requires, and a process outside them
    raises.  Without an initialised process group the world is one rank.
    ``device``: this rank's device (:func:`~.distributed.rank_device`).
    Raises the JAX package's ``ValueError`` when the shape does not fit.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    me = dist.get_rank() if dist.is_initialized() else 0
    group = None
    if dist.is_initialized():
        group = dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)
    if me not in ranks:
        raise ValueError(f"rank {me} is not one of the mesh's ranks {ranks}")
    return Mesh(data, model, ranks.index(me), rank_device(device), group)
