"""Frozen operation counts of one rank's stage-1 fine-tuning step from
the published shapes, in the convention of ``work/dust3r.py`` (matrix
products and convolutions, 2 operations a multiply-add): every frame
encoded, every pair decoded through the four heads, and the two mask
heads' backward. ``benchmark/tests/test_bench_finetune.py`` holds these
formulas to ``torch.utils.flop_counter`` on the reference model."""
from __future__ import annotations

from benchmark.work import dust3r as base


def _token_projections(m: dict, height: int, width: int) -> int:
    """The head's four 1 x 1 convolutions of the decoder's tokens (the
    encoder's for the first hook)."""
    p = m["patch_size"]
    n = (height // p) * (width // p)
    De, Dd = m["enc_embed_dim"], m["dec_embed_dim"]
    dims = base.LAYER_DIMS
    return 2 * n * (De * dims[0] + Dd * (dims[1] + dims[2] + dims[3]))


def mask_head_backward_flop(m: dict, height: int, width: int) -> int:
    """One view's mask head backward: the gradients of every weight and
    of every activation, but the tokens' (they are detached), so twice
    the forward less the token projections' input gradients."""
    return (2 * base._dpt_flop(m, height, width, True)
            - _token_projections(m, height, width))


def step_flop(m: dict, height: int, width: int, pairs: int) -> int:
    """One rank's step over ``pairs`` pairs: two encodes, a decode with
    its four heads and both views' mask head backward a pair."""
    return pairs * (2 * base.encode_flop(m, height, width)
                    + base.decode_flop(m, height, width)
                    + 2 * mask_head_backward_flop(m, height, width))
