"""mip-NeRF 360 step-function sampling (numpy).

Port of ``das3r_tpu/utils/stepfun.py``: the same numpy code.

Functional replacement for the reference's vendored ``utils/stepfun.py``
(402 LoC, mip-NeRF 360): piecewise-constant PDFs over a shared knot vector
``t`` with log-weights ``w_logits``, CDF integration, inverse-CDF
sampling. The reference uses it in one place — constant-speed resampling
of the ellipse camera path (utils/pose_utils.py:345 calls ``sample_np``
with the default ``deterministic_center=False``: an endpoint-including
linspace over ``n_frames + 1`` samples, whose duplicated last sample the
caller then drops) — but the full sampler is part of its public utility
surface, so the semantics are reproduced here:

- ``integrate_weights_np(w)``: exclusive cumulative sum clipped to [0, 1]
  with pinned 0/1 endpoints — the CDF of a histogram ``w`` (already
  normalized or not; callers pass softmax outputs).
- ``sample_np(rng, t, w_logits, num_samples, ...)``: draw samples from the
  distribution whose density is ``softmax(w_logits)`` spread uniformly
  over the intervals of ``t``, by inverting the CDF at stratified (or
  uniform-random) levels.

All pure numpy; used host-side only (camera-path generation is one-shot).
"""
from __future__ import annotations

import numpy as np


def searchsorted_np(a: np.ndarray, v: np.ndarray):
    """For each v, indices (lo, hi) of the knots in ``a`` bracketing it,
    clamped to valid interior intervals (a must be sorted along -1)."""
    idx = np.searchsorted(a, v, side="right")
    hi = np.clip(idx, 1, a.shape[-1] - 1)
    lo = hi - 1
    return lo, hi


def integrate_weights_np(w: np.ndarray) -> np.ndarray:
    """Histogram weights [..., K] -> CDF at the K+1 knots, in [0, 1] with
    cw[..., 0] = 0 and cw[..., -1] = 1 exactly."""
    cw = np.minimum(1.0, np.cumsum(w[..., :-1], axis=-1))
    shape = cw.shape[:-1] + (1,)
    return np.concatenate(
        [np.zeros(shape), cw, np.ones(shape)], axis=-1)


def weight_to_pdf_np(t: np.ndarray, w: np.ndarray,
                     eps: float = 1e-12) -> np.ndarray:
    """Histogram weights -> density over the intervals of ``t``."""
    return w / np.maximum(eps, np.diff(t, axis=-1))


def pdf_to_weight_np(t: np.ndarray, p: np.ndarray) -> np.ndarray:
    return p * np.diff(t, axis=-1)


def invert_cdf_np(u: np.ndarray, t: np.ndarray,
                  w_logits: np.ndarray) -> np.ndarray:
    """Inverse CDF of the step function (t, softmax(w_logits)) evaluated
    at levels u in [0, 1]."""
    w = np.exp(w_logits - w_logits.max(axis=-1, keepdims=True))
    w = w / w.sum(axis=-1, keepdims=True)
    cw = integrate_weights_np(w)
    lo, hi = searchsorted_np(cw, u)
    cw_lo = np.take_along_axis(cw, lo, axis=-1)
    cw_hi = np.take_along_axis(cw, hi, axis=-1)
    t_lo = np.take_along_axis(t, lo, axis=-1)
    t_hi = np.take_along_axis(t, hi, axis=-1)
    frac = np.where(cw_hi > cw_lo, (u - cw_lo) / np.maximum(
        1e-12, cw_hi - cw_lo), 0.0)
    return t_lo + frac * (t_hi - t_lo)


def sample_np(rng, t: np.ndarray, w_logits: np.ndarray, num_samples: int,
              single_jitter: bool = False,
              deterministic_center: bool = False) -> np.ndarray:
    """Draw ``num_samples`` from the step-function distribution.

    rng=None gives the deterministic grids the reference path code uses:
    interval centers when ``deterministic_center`` (pose_utils.py:345's
    const-speed resampling), else a [0, 1) linspace. With an rng,
    stratified samples (one shared jitter when ``single_jitter``).
    """
    eps = np.finfo(np.float32).eps
    if rng is None:
        if deterministic_center:
            pad = 1.0 / (2.0 * num_samples)
            u = np.linspace(pad, 1.0 - pad - eps, num_samples)
        else:
            u = np.linspace(0.0, 1.0 - eps, num_samples)
        u = np.broadcast_to(u, t.shape[:-1] + (num_samples,))
    else:
        u_max = eps + (1.0 - eps) / num_samples
        max_jitter = (1.0 - u_max) / (num_samples - 1) - eps
        d = 1 if single_jitter else num_samples
        u = (np.linspace(0.0, 1.0 - u_max, num_samples)
             + rng.random(t.shape[:-1] + (d,)) * max_jitter)
    return invert_cdf_np(u, t, w_logits)


def resample_const_speed_stepfun(positions: np.ndarray,
                                 n_out: int) -> np.ndarray:
    """Const-speed polyline resampling via the step-function sampler —
    exactly how generate_ellipse_path uses it (pose_utils.py:340-349):
    knots = [0..N-1], log-weights = log segment lengths, sample_np with
    the default deterministic_center=False over ``n_out + 1`` levels
    (a [0, 1-eps] linspace hitting both path endpoints), then drop the
    duplicated last sample — for a closed path the first and last knots
    coincide. Positions are linearly interpolated at the sampled knots
    (the reference re-evaluates its analytic ellipse there; for a dense
    polyline the lerp is the same operation)."""
    n = positions.shape[0]
    lengths = np.linalg.norm(np.diff(positions, axis=0), axis=-1)
    t = np.arange(n, dtype=np.float64)
    theta = sample_np(None, t, np.log(np.maximum(lengths, 1e-12)),
                      n_out + 1)[:-1]
    idx = np.clip(np.floor(theta).astype(np.int64), 0, n - 2)
    frac = theta - idx
    return (positions[idx] * (1.0 - frac[:, None])
            + positions[idx + 1] * frac[:, None])
