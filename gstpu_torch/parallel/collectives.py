"""Collectives of the multi-device path, with their gradients.

The JAX package's collectives are ``all_gather``, ``psum_scatter``,
``psum``, ``pmax`` and ``ppermute`` under ``shard_map``, with JAX's VJPs.
Here they are ``torch.distributed`` calls on the process groups of a
``parallel.mesh.Mesh`` axis:

- ``all_gather_rows`` / ``all_gather_many``: tiled all-gather along axis 0;
  ``AllGather`` is the autograd form, whose backward is the reduce-scatter
  of the gradient (the all-gather's VJP);
- ``reduce_scatter_rows``: the sum over the group, rank i keeping rows
  block i;
- ``all_reduce``: sum or max;
- ``Exchange``: the two-neighbour exchange that replaces ``ppermute`` on a
  ring (``dist.batch_isend_irecv``), an autograd function whose backward
  is the exchange in the other direction.

Several tensors go in one call where they share the rows: their bytes
(or, for sums, their float32 columns) are packed side by side.

Backends.  Under NCCL the reductions are NCCL's, on the card.  gloo would
add up a reduction on the host, so under gloo it uses the backend only
to move the summands: the reduce-scatter is an all-to-all of the row
blocks and the all-reduce an all-gather, and each rank adds up what it
received on the tensor's own device.  gloo's own CUDA collectives copy
through host memory; the transports in ``GLOO_HOST_ONLY``, which gloo
fails for CUDA tensors, are handed a host copy instead and their result is
copied back (``chip_smoke.py``'s gloo probe tells which).  A group of one
rank is the identity, with no call.  Each call adds the bytes it hands to
the backend from this rank to the counter ``collective.bytes.<op>``
(``utils/tracing.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gstpu_torch.utils import tracing

# The three transports of the gloo path, and those gloo fails for CUDA
# tensors: on an H100 with torch 2.11, send and receive write the device
# pointer to the socket ("writev: Bad address"); all-gather and all-to-all
# take CUDA tensors (chip_smoke.gloo_probe)
GLOO_TRANSPORTS = ("all_gather", "all_to_all", "exchange")
GLOO_HOST_ONLY = frozenset({"exchange"})


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _transport(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``x`` as the backend is handed it for the transport ``kind``: a host
    copy of a CUDA tensor where gloo fails CUDA tensors for it."""
    if x.is_cuda and kind in GLOO_HOST_ONLY and _gloo(group):
        return x.cpu()
    return x


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _pack_bytes(tensors) -> torch.Tensor:
    """(n, B) uint8: each tensor's rows as bytes, side by side."""
    n = tensors[0].shape[0]
    return torch.cat([t.contiguous().reshape(n, -1).view(torch.uint8)
                      for t in tensors], dim=1)


def _unpack_bytes(packed: torch.Tensor, like) -> list:
    out, col = [], 0
    n = packed.shape[0]
    for t in like:
        width = t[:1].numel() * t.element_size()
        piece = packed[:, col:col + width].contiguous().view(t.dtype)
        out.append(piece.reshape((n,) + tuple(t.shape[1:])))
        col += width
    return out


def _pack_floats(tensors) -> torch.Tensor:
    n = tensors[0].shape[0]
    return torch.cat([t.reshape(n, -1) for t in tensors], dim=1)


def _unpack_floats(packed: torch.Tensor, like) -> list:
    out, col = [], 0
    n = packed.shape[0]
    for t in like:
        width = t[:1].numel()
        out.append(packed[:, col:col + width].reshape(
            (n,) + tuple(t.shape[1:])))
        col += width
    return out


def _gathered(x: torch.Tensor, group, size: int, counter: str) -> list:
    """Every rank's ``x`` of ``group``, by index, on ``x``'s device."""
    send = _transport(x.contiguous(), group, "all_gather")
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    tracing.COUNTERS.add(f"collective.bytes.{counter}", _nbytes(send))
    return [p.to(x.device) for p in parts]


def all_gather_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """The rows of every rank of ``axis`` (a ``mesh.Axis``), in index
    order: (size * n, ...) from this rank's (n, ...)."""
    if axis.size == 1:
        return x
    return torch.cat(_gathered(x, axis.group, axis.size, "all_gather"))


def all_gather_many(tensors, axis) -> list:
    """``all_gather_rows`` of several tensors with the same number of rows,
    in one call (any dtypes)."""
    tensors = list(tensors)
    if axis.size == 1:
        return tensors
    return _unpack_bytes(all_gather_rows(_pack_bytes(tensors), axis),
                         tensors)


def reduce_scatter_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """Block ``axis.index`` of the sum of ``x`` over the ranks of ``axis``
    (the row count must divide by the size)."""
    if axis.size == 1:
        return x
    if x.shape[0] % axis.size:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{axis.size} ranks")
    x = x.contiguous()
    rows = x.shape[0] // axis.size
    if _gloo(axis.group):
        # block j goes to rank j; this rank adds up the blocks it receives
        send = _transport(x, axis.group, "all_to_all")
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=axis.group)
        tracing.COUNTERS.add("collective.bytes.reduce_scatter",
                             _nbytes(send))
        blocks = recv.to(x.device).reshape((axis.size, rows)
                                           + tuple(x.shape[1:]))
        return blocks.sum(0)
    out = torch.empty_like(x[:rows])
    # the list form: reduce_scatter_tensor is deprecated from torch 2.13
    dist.reduce_scatter(out, list(x.chunk(axis.size)), group=axis.group)
    tracing.COUNTERS.add("collective.bytes.reduce_scatter", _nbytes(x))
    return out


def reduce_scatter_many(tensors, axis) -> list:
    """``reduce_scatter_rows`` of several float32 tensors with the same
    number of rows, in one call."""
    tensors = list(tensors)
    if axis.size == 1:
        return tensors
    return _unpack_floats(reduce_scatter_rows(_pack_floats(tensors), axis),
                          tensors)


def all_reduce(x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """The sum (or, with ``op="max"``, the maximum) of ``x`` over the ranks
    of ``axis`` (a ``mesh.Axis``, or None for every rank); a new tensor,
    the same on every rank."""
    group = None if axis is None else axis.group
    if axis is not None:
        size = axis.size
    else:
        size = dist.get_world_size() if dist.is_initialized() else 1
    if size == 1:
        return x.clone()
    x = x.detach()
    if _gloo(group):
        # every rank receives every summand and adds them up itself
        parts = torch.stack(_gathered(x, group, size, "all_reduce"))
        return parts.amax(0) if op == "max" else parts.sum(0)
    out = x.clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    tracing.COUNTERS.add("collective.bytes.all_reduce", _nbytes(out))
    return out


def all_reduce_many(tensors, axis) -> list:
    """The sums of several float32 tensors over ``axis``, in one call."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    summed = all_reduce(flat, axis)
    out, at = [], 0
    for t in tensors:
        out.append(summed[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


class AllGather(torch.autograd.Function):
    """Tiled all-gather of float32 tensors over a mesh axis; the backward is
    the reduce-scatter of their gradients."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        if axis.size == 1:
            return tuple(t.view_as(t) for t in tensors)
        packed = all_gather_rows(_pack_floats(tensors).contiguous(), axis)
        return tuple(_unpack_floats(packed, tensors))

    @staticmethod
    def backward(ctx, *grads):
        if ctx.axis.size == 1:
            return (None,) + grads
        return (None,) + tuple(reduce_scatter_many(grads, ctx.axis))


def all_gather_params(params: dict, axis) -> dict:
    """The differentiable all-gather of a dict of parameter shards."""
    return dict(zip(params, AllGather.apply(axis, *params.values())))


def exchange(up: torch.Tensor, down: torch.Tensor, axis):
    """Send ``up`` to the rank before this one on the ring of ``axis`` and
    ``down`` to the rank after it; returns (what the rank after sent up,
    what the rank before sent down).  Not differentiable; see
    ``Exchange``."""
    if axis.size == 1:
        return up, down
    n, i = axis.size, axis.index
    prev, nxt = axis.ranks[(i - 1) % n], axis.ranks[(i + 1) % n]
    send_up = _transport(up.contiguous(), axis.group, "exchange")
    send_down = _transport(down.contiguous(), axis.group, "exchange")
    from_next = torch.empty_like(send_up)
    from_prev = torch.empty_like(send_down)
    ops = [dist.P2POp(dist.isend, send_up, prev, axis.group, tag=0),
           dist.P2POp(dist.isend, send_down, nxt, axis.group, tag=1),
           dist.P2POp(dist.irecv, from_next, nxt, axis.group, tag=0),
           dist.P2POp(dist.irecv, from_prev, prev, axis.group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    tracing.COUNTERS.add("collective.bytes.exchange",
                         _nbytes(send_up) + _nbytes(send_down))
    return from_next.to(up.device), from_prev.to(down.device)


class Exchange(torch.autograd.Function):
    """``exchange`` with its gradient: a tensor received from a neighbour
    sends its gradient back to it, so the backward is the exchange in the
    other direction (``ppermute``'s VJP)."""

    @staticmethod
    def forward(ctx, axis, up, down):
        ctx.axis = axis
        return exchange(up, down, axis)

    @staticmethod
    def backward(ctx, g_from_next, g_from_prev):
        g_down, g_up = exchange(g_from_prev.contiguous(),
                                g_from_next.contiguous(), ctx.axis)
        return None, g_up, g_down
