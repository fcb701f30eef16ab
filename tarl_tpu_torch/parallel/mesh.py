"""The device mesh of the batched trainer (ports ``tarl_tpu/parallel/
mesh.py``: ``make_mesh``).

A mesh of ``dp x sp`` devices: ``dp`` data parallel over the environment
replicas, ``sp`` the update batch's second axis.  The reference builds a
``jax.sharding.Mesh``; here it is a small record of the shape and the
devices, over the cards ``torch.cuda.device_count()`` sees, or the CPU as
one device.  A mesh never asks for more devices than exist.  With a
``torch.distributed`` group the ``dp x sp`` cells are the group's ranks,
row-major (rank ``d * sp + s``), and a process's mesh holds its own device.

:class:`Ranks` is the transport between the ranks of a group, shared by
the batched trainer and the block meshes
(:class:`~tarl_tpu_torch.parallel.shard_map_episode.RoadMesh`): a gather
and a sum that carry gradients across ranks, and one all-reduce of a
list of float tensors.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device


class DeviceMesh:
    """``shape = {"dp": dp, "sp": sp}`` and its ``dp * sp`` ``devices``,
    row-major over ``(dp, sp)``."""

    def __init__(self, devices: list, dp: int, sp: int, group=None,
                 rank: int = 0):
        self.devices = list(devices)
        self.shape = {"dp": dp, "sp": sp}
        self.group = group      # the ranks' process group, or None
        self.rank = rank        # this process's cell, d * sp + s


class Ranks:
    """The ranks of a ``torch.distributed`` ``group``, this one's tensors
    on ``device``.  An NCCL group takes the tensors on the card as they
    are.  A gloo group takes them on the host: tensors on the card are
    copied to the host and back around each collective.  That is the
    CPU's transport, and on one card the check of the protocol across
    processes, not a transport for work across cards.  Neither backend
    stands in for the other.

    Every rank ends each collective with the same bits.  A gather copies;
    a float sum adds in the ring's order, which is not a one-process
    order, so a float result is held to a tolerance where an integer one
    is exact.  :meth:`gather` and :meth:`sum` carry gradients: the
    backward of a gather is the sum of every rank's cotangent, sliced to
    this rank's rows (gloo has no reduce-scatter), and that of a sum the
    sum of the cotangents."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = device
        backend = dist.get_backend(group)
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"an NCCL group takes tensors on the card, "
                             f"not on {device}")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"no transport over the {backend} backend")
        self._staged = backend == "gloo" and device.type != "cpu"

    def _gather(self, rows: torch.Tensor) -> torch.Tensor:
        part = rows.cpu() if self._staged else rows.contiguous()
        out = torch.empty((self.world * part.shape[0],) + tuple(
            part.shape[1:]), dtype=part.dtype, device=part.device)
        # all_gather_single is all_gather_into_tensor's newer name.
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        gather(out, part, group=self.group)
        return out.to(self.device) if self._staged else out

    def _reduce(self, x: torch.Tensor, fresh: bool = False) -> torch.Tensor:
        """The sum over the ranks of ``x``: a new tensor, or ``x`` summed in
        place where it is ``fresh`` (contiguous, made for the sum)."""
        part = x.cpu() if self._staged else x if fresh else x.clone(
            memory_format=torch.contiguous_format)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self.group)
        return part.to(self.device) if self._staged else part

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` rows of this rank -> ``[world * n, ...]``, the
        ranks' rows in rank order; differentiable."""
        if rows.requires_grad and torch.is_grad_enabled():
            return _GatherRanks.apply(self, rows)
        return self._gather(rows)

    def sum(self, x: torch.Tensor, fresh: bool = False) -> torch.Tensor:
        """``x`` summed over the ranks (in place where it is ``fresh`` and
        carries no gradient); differentiable."""
        if x.requires_grad and torch.is_grad_enabled():
            return _SumRanks.apply(self, x)
        return self._reduce(x, fresh)

    def sum_tensors(self, tensors: list) -> list:
        """Each of ``tensors`` (float partials of one dtype) summed over the
        ranks, in one all-reduce of their concatenation."""
        flat = self._reduce(torch.cat([t.reshape(-1) for t in tensors]),
                            fresh=True)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return out


class _GatherRanks(torch.autograd.Function):
    """:meth:`Ranks.gather` with its transpose: the cotangents of every
    rank summed, this rank's rows kept."""

    @staticmethod
    def forward(ctx, ranks, rows):
        ctx.ranks, ctx.n = ranks, rows.shape[0]
        return ranks._gather(rows)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.ranks.rank * ctx.n
        return None, ctx.ranks._reduce(grad)[lo:lo + ctx.n]


class _SumRanks(torch.autograd.Function):
    """The sum over ranks, whose every output feeds each rank's input:
    the backward sums the cotangents."""

    @staticmethod
    def forward(ctx, ranks, x):
        ctx.ranks = ranks
        return ranks._reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.ranks._reduce(grad)


def _devices(device) -> list:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"no mesh over {dev.type} devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, *, dp: int | None = None,
              sp: int | None = None, device=None, group=None) -> DeviceMesh:
    """A ``("dp", "sp")`` mesh over the first ``n_devices`` devices of
    ``device``'s kind (``None``: every card; ``"cpu"``: the CPU, one
    device).  Defaults as the reference's: every device, ``sp = 2`` when
    the count is even and at least 4, else 1, and ``dp = n // sp``.
    Raises where ``n_devices`` exceeds the devices there are, or ``dp *
    sp`` is not ``n_devices``.

    With a ``torch.distributed`` ``group`` the cells are its W ranks
    (``n_devices``, if given, must be W) and the mesh holds this rank's
    ``device`` (``None``: ``cuda:<LOCAL_RANK>``, the group rank where the
    environment names none)."""
    if group is not None:
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        if n_devices not in (None, n):
            raise ValueError(f"a mesh of {n_devices} over a group of {n} "
                             f"ranks")
        if device is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", rank)))
        dp, sp = _shape(n, dp, sp)
        return DeviceMesh([resolve_device(device)], dp, sp, group, rank)
    devices = _devices(device)
    n = n_devices or len(devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"a mesh of {n} devices: {len(devices)} "
                         f"{resolve_device(device).type} device(s) exist")
    dp, sp = _shape(n, dp, sp)
    return DeviceMesh(devices[:n], dp, sp)


def _shape(n: int, dp: int | None, sp: int | None) -> tuple[int, int]:
    if sp is None:
        sp = 2 if (n >= 4 and n % 2 == 0) else 1
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} devices")
    return dp, sp
