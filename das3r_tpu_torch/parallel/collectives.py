"""The collectives of the sharded render and step, over
``torch.distributed`` process groups (one per mesh axis, ``parallel/
mesh.py``).

Only ``all_reduce`` is issued. A gather is an all-reduce of a zero-filled
buffer that holds this rank's rows, and so is ``broadcast_object`` (one
rank's pickled bytes, the others' zeros) and ``barrier`` (one zero):
adding zeros is exact, so the gathered tensor is bitwise the
concatenation of the ranks' blocks, and
``all_reduce`` is among the collectives that every backend offers on both
CPU and CUDA tensors (gloo offers only it and ``broadcast`` on CUDA
tensors). A group of None, or of one rank, is no communication at all:
the unsharded step runs the same code. Every call reports its result
bytes to ``comm_stats`` under a family and a tag.

Two autograd forms carry the sharded step's gradients:

* ``gather_rows``: forward, the concatenation of every rank's block;
  backward, this rank's rows of the gradient. The ranks compute the same
  function of the gathered tensor (the image and the loss are whole on
  every rank), so the gradient of its own block is the gradient each rank
  already holds; summing would count it once per rank.
* ``sum_grads``: forward, the identity; backward, the gradients summed
  over the group. A tensor that every rank holds whole (the attribute
  table under tile sharding; the pose, the FoV and ``conf_static`` under
  Gaussian sharding) and that each rank uses for its own part of the
  work (its tile range; its Gaussians) gets from each rank the gradient
  of that part only.
"""
from __future__ import annotations

import pickle

import torch
import torch.distributed as dist

from das3r_tpu_torch.parallel import comm_stats


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
               family: str = "all-reduce", tag: str = "") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (and returned)."""
    if size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
        comm_stats.record(family, tag, x.numel() * x.element_size())
    return x


def gather_blocks(x: torch.Tensor, group, tag: str = "") -> torch.Tensor:
    """[R * m, ...]: the [m, ...] blocks of the group's R ranks in rank
    order (every rank's block has the same shape). Not differentiable;
    see ``gather_rows``."""
    n = size(group)
    if n == 1:
        return x
    m = x.shape[0]
    buf = x.new_zeros((n * m,) + tuple(x.shape[1:]))
    buf[index(group) * m:(index(group) + 1) * m] = x
    return all_reduce(buf, group, family="all-gather", tag=tag)


def broadcast_object(obj, group, device, tag: str = ""):
    """Group rank 0's ``obj`` (any picklable object; the others pass
    anything) on every rank of ``group``: its pickled bytes, one per int32,
    all-reduced with the other ranks' zeros on ``device`` (the group's
    device: a CUDA one for NCCL). Two all-reduces, the length and the
    bytes, counted under the family "broadcast"."""
    if size(group) == 1:
        return obj
    mine = index(group) == 0
    data = pickle.dumps(obj) if mine else b""
    n = torch.tensor([len(data)], dtype=torch.int64, device=device)
    all_reduce(n, group, family="broadcast", tag=tag)
    buf = torch.zeros(int(n), dtype=torch.int32, device=device)
    if mine:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    all_reduce(buf, group, family="broadcast", tag=tag)
    return obj if mine else pickle.loads(
        buf.to(torch.uint8).cpu().numpy().tobytes())


def barrier(group, device, tag: str = "") -> None:
    """Return once every rank of ``group`` has reached the call: one
    all-reduce of a zero on ``device``, counted under "barrier"."""
    if size(group) > 1:      # the host waits for the result
        all_reduce(torch.zeros(1, device=device), group, family="barrier",
                   tag=tag).item()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.rows = (index(group) * x.shape[0], x.shape[0])
        return gather_blocks(x.detach(), group, tag)

    @staticmethod
    def backward(ctx, g):
        r0, m = ctx.rows
        return g[r0:r0 + m], None, None


def gather_rows(x: torch.Tensor, group, tag: str = "") -> torch.Tensor:
    """``gather_blocks``, differentiable: the gradient of this rank's
    block is its rows of the gathered tensor's gradient (module
    docstring)."""
    if size(group) == 1:
        return x
    return _GatherRows.apply(x, group, tag)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, tag, *xs):
        ctx.group, ctx.tag = group, tag
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=d, device=v) if g is None else g
              for g, (s, d, v) in zip(gs, ctx.shapes)]
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce(flat, ctx.group, tag=ctx.tag)
        out, i = [], 0
        for g in gs:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return (None, None, *out)


def sum_grads(group, tag: str, *xs: torch.Tensor):
    """The tensors ``xs`` as they are, whose gradients are summed over
    ``group`` in one all-reduce (module docstring). Returns a tuple."""
    if size(group) == 1:
        return xs
    return _SumGrads.apply(group, tag, *xs)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        return all_reduce(x.detach().clone(), group, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_sum(x: torch.Tensor, group, tag: str = "") -> torch.Tensor:
    """``x`` summed over ``group``, differentiable: the gradient of this
    rank's term is the gradient of the sum. Every rank computes the same
    function of the sum (a global masked mean), so the gradient each rank
    holds is already that of its own term; the ranks' parameter gradients
    are summed afterwards."""
    if size(group) == 1:
        return x
    return _ReduceSum.apply(x, group, tag)
