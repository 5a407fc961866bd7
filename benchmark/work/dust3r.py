"""Frozen operation counts of stage 1's predictor (DUSt3R ViT-L encoder,
two ViT-B decoders, four DPT heads) from its published shapes: the
matrix products and convolutions, 2 operations a multiply-add, and
nothing else (norms, softmax, activations and resizes are left out).
``benchmark/tests/test_bench_work.py`` holds these formulas to
``torch.utils.flop_counter`` on the reference model."""
from __future__ import annotations

LAYER_DIMS = (96, 192, 384, 768)   # DPT's per-hook widths
FEATURE = 256                      # DPT's fused width
LAST = 128                         # the regression head's last width


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    """A k x k convolution with an h x w output."""
    return 2 * h * w * cin * cout * k * k


def encode_flop(m: dict, height: int, width: int) -> int:
    """One frame through the patch embedding and the encoder."""
    p, D = m["patch_size"], m["enc_embed_dim"]
    n = (height // p) * (width // p)
    hidden = int(D * m["mlp_ratio"])
    block = 2 * n * D * (3 * D + D + 2 * hidden) + 4 * n * n * D
    return 2 * n * 3 * p * p * D + m["enc_depth"] * block


def _dpt_flop(m: dict, height: int, width: int, semseg: bool) -> int:
    p = m["patch_size"]
    nh, nw = height // p, width // p
    n = nh * nw
    De, Dd = m["enc_embed_dim"], m["dec_embed_dim"]
    ld = LAYER_DIMS
    f = 2 * n * De * ld[0] + 2 * n * ld[0] * ld[0] * 16      # 1x1, up x4
    f += 2 * n * Dd * ld[1] + 2 * n * ld[1] * ld[1] * 4      # 1x1, up x2
    f += 2 * n * Dd * ld[2]                                  # 1x1
    h4, w4 = -(-nh // 2), -(-nw // 2)
    f += 2 * n * Dd * ld[3] + _conv(h4, w4, ld[3], ld[3], 3)  # 1x1, s2
    sizes = [(4 * nh, 4 * nw), (2 * nh, 2 * nw), (nh, nw), (h4, w4)]
    for (h, w), c in zip(sizes, ld):
        f += _conv(h, w, c, FEATURE, 3)                      # layer_rn
    # refinenets 4..1: residual units (4 at 1..3, 2 at 4), then a 1x1
    # after the x2 upsampling
    for i, (h, w) in enumerate(reversed(sizes)):
        units = 2 if i == 0 else 4
        f += units * _conv(h, w, FEATURE, FEATURE, 3)
        f += _conv(2 * h, 2 * w, FEATURE, FEATURE, 1)
    h1, w1 = 8 * nh, 8 * nw
    if semseg:
        f += _conv(h1, w1, FEATURE, FEATURE, 3) + _conv(h1, w1, FEATURE, 1, 1)
    else:
        f += (_conv(h1, w1, FEATURE, FEATURE // 2, 3)
              + _conv(height, width, FEATURE // 2, LAST, 3)
              + _conv(height, width, LAST, 4, 1))
    return f


def decode_flop(m: dict, height: int, width: int) -> int:
    """One pair through the decoder embedding, both decoders and the four
    heads."""
    p, De, D = m["patch_size"], m["enc_embed_dim"], m["dec_embed_dim"]
    n = (height // p) * (width // p)
    hidden = int(D * m["mlp_ratio"])
    # self-attention (qkv, proj), cross-attention (q, k, v, proj), MLP
    block = 2 * n * D * (4 * D + 4 * D + 2 * hidden) + 8 * n * n * D
    f = 2 * (2 * n * De * D) + 2 * m["dec_depth"] * block
    return f + 2 * (_dpt_flop(m, height, width, False)
                    + _dpt_flop(m, height, width, True))
