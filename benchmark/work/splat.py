"""Frozen operation and byte counts of the splat cells, computed from
the inputs (a view's blend evaluations, entries and Gaussians, as the
reference counts them) and never from what the program reports.

Per-evaluation constants are chip_smoke.py's (lines 295-301):
``BLEND_FLOP_PER_EVAL = 15`` (power, alpha, the tests and the T update)
and ``BLEND_BWD_FLOP_PER_EVAL = 55`` (power and alpha ~12, T restore, w,
gC . c, dalpha and S ~13, the nine gradient terms ~30). The others are
counted here from the equations, per Gaussian, pixel or parameter.
"""
from __future__ import annotations

BLEND_FLOP_PER_EVAL = 15
BLEND_BWD_FLOP_PER_EVAL = 55
# camera transform and rotation (46), 3-D covariance (80), EWA 2-D
# covariance, conic, radius and rect (105), view direction (10)
PREPROCESS_GEOMETRY_FLOP = 241
# the SH basis up to each active degree; the colour adds (degree + 1)^2
# x 3 multiply-adds (degree 3: 40 + 96 = 136)
SH_BASIS_FLOP = (0, 3, 18, 40)
# per pixel, 3 channels: SSIM's five maps through 11 + 11 taps (660),
# its ratio (66), the L1 and the weights (24)
LOSS_FLOP_PER_PIXEL = 750
LOSS_BWD_FLOP_PER_PIXEL = 2 * LOSS_FLOP_PER_PIXEL
ADAM_FLOP_PER_ELEMENT = 12
TABLE_ROW_BYTES = 9 * 4          # mean 2, conic 3, rgb 3, opacity, f32
TILE_PIXELS = 256


def blend_forward(v: dict, tiles: int, train: bool) -> tuple[float, float]:
    """(FP32 operations, bytes) of the forward blend of one view ``v``
    ({evals, entries, binnable}): each table row, entry rank and tile
    offset read once, each tile pixel's colour and transmittance (and in
    training its last contributor) written once."""
    out_px = 4 * (3 + 1 + (1 if train else 0))
    nbytes = (v["binnable"] * TABLE_ROW_BYTES + v["entries"] * 4
              + tiles * 8 + tiles * TILE_PIXELS * out_px)
    return BLEND_FLOP_PER_EVAL * v["evals"], float(nbytes)


def blend_backward(v: dict, tiles: int) -> tuple[float, float]:
    """(FP32 operations, bytes) of the backward blend of one view: the
    table, ranks, offsets, each pixel's incoming gradients (colour and
    transmittance), final transmittance and last contributor read once,
    each row's gradient written once."""
    nbytes = (2 * v["binnable"] * TABLE_ROW_BYTES + v["entries"] * 4
              + tiles * 8 + tiles * TILE_PIXELS * 4 * (3 + 1 + 1 + 1))
    return BLEND_BWD_FLOP_PER_EVAL * v["evals"], float(nbytes)


def preprocess_flop(sh_degree: int) -> int:
    """FP32 operations of one Gaussian's preprocess at an active SH
    degree (its backward counts twice as many)."""
    return (PREPROCESS_GEOMETRY_FLOP + SH_BASIS_FLOP[sh_degree]
            + 6 * (sh_degree + 1) ** 2)


def train_step_flop(v: dict, n_gauss: int, pixels: int, n_params: int,
                    sh_degree: int) -> float:
    """Counted FP32 operations of one training step on view ``v``."""
    return ((BLEND_FLOP_PER_EVAL + BLEND_BWD_FLOP_PER_EVAL) * v["evals"]
            + 3 * preprocess_flop(sh_degree) * n_gauss
            + (LOSS_FLOP_PER_PIXEL + LOSS_BWD_FLOP_PER_PIXEL) * pixels
            + ADAM_FLOP_PER_ELEMENT * n_params)


def render_flop(v: dict, n_gauss: int, sh_degree: int) -> float:
    """Counted FP32 operations of one forward render of view ``v``."""
    return (BLEND_FLOP_PER_EVAL * v["evals"]
            + preprocess_flop(sh_degree) * n_gauss)
