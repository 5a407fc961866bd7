"""k-nearest-neighbour mean squared distance (port of
``das3r_tpu/ops/knn.py``, the replacement of ``simple_knn._C.distCUDA2``).

Used once, at Gaussian init, to size the initial scales. A blocked brute
force: for a block of B query rows, the squared distances to all N points
by the expansion |q - p|^2 = |q|^2 - 2 q.p + |p|^2, the self-distance
masked, then the k smallest (XLA ops, not a Pallas kernel, in the JAX
package). The three-term product q.p is written out elementwise rather
than left to a matrix product, whose summation order may change with the
block's shape: so each distance is computed the same way at any block.
"""
from __future__ import annotations

import torch

# The [B, N] distance block of one step, in bytes: B is chosen so that the
# block stays within this budget.
BLOCK_BYTES = 1 << 30


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     block: int | None = None) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest neighbours.

    Args:
      points: [N, 3] float tensor, on the device that computes.
      k: neighbour count (3 matches distCUDA2).
      block: query rows per step; None sizes the [B, N] block to
        ``BLOCK_BYTES``. The result does not depend on it.

    Returns [N] of ``points``' dtype; inf where fewer than k other points
    exist.
    """
    n = points.shape[0]
    pts = points.to(torch.float32)
    if block is None:
        block = max(1, min(n, BLOCK_BYTES // (4 * max(n, 1))))
    sq = (pts * pts).sum(-1)                                    # [N]
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    kk = min(k, n)
    for b0 in range(0, n, block):
        q = pts[b0:b0 + block]
        # (|q|^2 - 2 q.p) + |p|^2, the JAX package's order: the expansion
        # cancels for near neighbours, so the order shows in the result
        d2 = q[:, 0:1] * pts[:, 0]
        for j in (1, 2):
            d2 += q[:, j:j + 1] * pts[:, j]
        d2.mul_(-2.0).add_(sq[b0:b0 + block, None]).add_(sq)
        d2.clamp_min_(0.0).diagonal(offset=b0).fill_(float("inf"))
        d2 = torch.topk(d2, kk, dim=1, largest=False).values
        if kk < k:
            d2 = torch.cat([d2, torch.full((d2.shape[0], k - kk),
                                           float("inf"), device=d2.device)], 1)
        out[b0:b0 + block] = d2.mean(-1)
    return out.to(points.dtype)
