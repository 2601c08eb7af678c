"""The collectives of the sharded tier, written in one place.

The JAX package needs no such module: ``jax.lax.psum``, ``pmin`` and
``pmax`` under ``shard_map`` already have the semantics it needs. Here
they are ``torch.distributed.all_reduce`` calls on explicit process
groups, with these rules:

- ``all_reduce_sum`` is differentiable, and its backward is the
  identity. That is the transpose of JAX's ``psum`` whose output is
  replicated: every rank of the group computes the same loss from the
  sum, and each rank pushes the gradient into its own partial only.
  (``torch.distributed.nn.functional.all_reduce`` sums the gradient
  over the group again, which multiplies every gradient by the group's
  size.)
- ``all_reduce_min`` and ``all_reduce_max`` carry no gradient.
- ``broadcast`` (no gradient) sends one rank's tensor to its group: the
  meshed serving loop's per-tick control record and scene snapshots.
- Only ``all_reduce`` and ``broadcast`` are used: gloo runs them (through
  host copies) on CUDA tensors, and no other collective.
- ``group=None`` means "no mesh": every function returns its input, so
  the single-process path runs no collective.

Every rank of a group must make the same calls in the same order; a rank
that skips one leaves the others waiting.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: Tensor, group=None) -> Tensor:
    """The sum of ``x`` over ``group``; its gradient is the identity."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_sums(xs, group=None) -> list[Tensor]:
    """``all_reduce_sum`` of several float tensors in one collective."""
    if group is None:
        return list(xs)
    flat = all_reduce_sum(torch.cat([x.reshape(-1) for x in xs]), group)
    out, start = [], 0
    for x in xs:
        out.append(flat[start:start + x.numel()].reshape(x.shape))
        start += x.numel()
    return out


def _reduce(x: Tensor, op, group) -> Tensor:
    if group is None:
        return x
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_reduce_min(x: Tensor, group=None) -> Tensor:
    """The elementwise minimum of ``x`` over ``group`` (no gradient)."""
    return _reduce(x, dist.ReduceOp.MIN, group)


def all_reduce_max(x: Tensor, group=None) -> Tensor:
    """The elementwise maximum of ``x`` over ``group`` (no gradient)."""
    return _reduce(x, dist.ReduceOp.MAX, group)


def broadcast(x: Tensor, src: int = 0, group=None) -> Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, written
    into ``x`` in place (a contiguous tensor) and returned (no
    gradient)."""
    if group is None:
        return x
    dist.broadcast(x, src=src, group=group)
    return x
