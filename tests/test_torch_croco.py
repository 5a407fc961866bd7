"""PyTorch port: the stage-1 predictor (``das3r_tpu_torch/models/croco``)
against the flax modules of the JAX package on the same weights.

Weights come from the testkit's seeded generator in the reference
checkpoint's layout: the port loads them as they are, the JAX package
through ``convert_torch_state_dict``. Inputs are numpy from a seed; TF32
is off. Bars are relative to the largest magnitude of the reference map
(``expm1`` and ``exp`` at the heads amplify error); the measured maxima
are in PERF.md §6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.models.croco import blocks as jblocks
from das3r_tpu.models.croco import dpt as jdpt
from das3r_tpu.models.croco import rope as jrope
from das3r_tpu.models.croco.convert import convert_torch_state_dict
from das3r_tpu.models.croco.dust3r import AsymmetricCroCo3D as JModel
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.predictor import inference as jinference
from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.models.croco import dpt as tdpt
from das3r_tpu_torch.models.croco import rope as trope
from das3r_tpu_torch.models.croco.dust3r import (DUST3R_LARGE_CONFIG,
                                                 AsymmetricCroCo3D)
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import inference as tinference

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
REL = 1e-4         # x max|ref| per map: the model outputs
MODULE_REL = 1e-5  # x max|ref|: one block or head
H, W = 32, 48


@pytest.fixture(scope="module")
def weights():
    """(numpy state dict, flax params, the port's model) on one seed."""
    sd = random_torch_state_dict(TINY, np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, JTINY))
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, sd)
    return sd, params, model


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _images(seed, n=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, h, w)).astype(np.float32),
            rng.standard_normal((n, 3, h, w)).astype(np.float32))


def _assert_res(got: dict, want: dict, rel=REL):
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k].detach().numpy(), want[k]) <= rel, k


# ---------------------------------------------------------------------------
# modules


def test_rope_2d_matches_jax():
    rng = np.random.default_rng(3)
    tok = rng.standard_normal((2, 3, 6, 16)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 6, 2))
    want = jrope.rope_2d(jnp.asarray(tok), jnp.asarray(pos))
    got = trope.rope_2d(_t(tok), _t(pos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    assert trope._inv_freq(8, 100.0).dtype == np.float32
    np.testing.assert_array_equal(trope._inv_freq(8, 100.0),
                                  jrope._inv_freq(8, 100.0))


def test_patch_embed_matches_flax(weights):
    _, params, model = weights
    img = _images(1)[0]
    want, wpos = jblocks.PatchEmbed(16, TINY.enc_embed_dim).apply(
        {"params": params["patch_embed"]}, jnp.asarray(img))
    got, pos = model.patch_embed(_t(img))
    assert _rel(got.detach().numpy(), want) <= MODULE_REL
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(pos[0, :3].numpy(), [[0, 0], [0, 1],
                                                       [0, 2]])


def _tokens(rng, n, d):
    return rng.standard_normal((2, n, d)).astype(np.float32)


def _positions(n_y, n_x):
    yy, xx = np.meshgrid(np.arange(n_y), np.arange(n_x), indexing="ij")
    return np.broadcast_to(np.stack([yy, xx], -1).reshape(1, -1, 2),
                           (2, n_y * n_x, 2)).copy()


def test_attention_and_encoder_block_match_flax(weights):
    _, params, model = weights
    rng = np.random.default_rng(4)
    D, heads = TINY.enc_embed_dim, TINY.enc_num_heads
    x, pos = _tokens(rng, 6, D), _positions(2, 3)
    p = params["enc_blocks_0"]
    want = jblocks.Attention(D, heads).apply(
        {"params": p["attn"]}, jnp.asarray(x), jnp.asarray(pos))
    got = model.enc_blocks[0].attn(_t(x), _t(pos))
    assert _rel(got.detach().numpy(), want) <= MODULE_REL
    want = jblocks.Block(D, heads).apply({"params": p}, jnp.asarray(x),
                                         jnp.asarray(pos))
    got = model.enc_blocks[0](_t(x), _t(pos))
    assert _rel(got.detach().numpy(), want) <= MODULE_REL


def test_cross_attention_and_decoder_block_match_flax(weights):
    _, params, model = weights
    rng = np.random.default_rng(5)
    D, heads = TINY.dec_embed_dim, TINY.dec_num_heads
    x, y = _tokens(rng, 6, D), _tokens(rng, 6, D)
    xpos, ypos = _positions(2, 3), _positions(3, 2)
    p = params["dec_blocks2_1"]
    want = jblocks.CrossAttention(D, heads).apply(
        {"params": p["cross_attn"]}, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(y), jnp.asarray(xpos), jnp.asarray(ypos))
    got = model.dec_blocks2[1].cross_attn(_t(x), _t(y), _t(y), _t(xpos),
                                          _t(ypos))
    assert _rel(got.detach().numpy(), want) <= MODULE_REL
    want, _ = jblocks.DecoderBlock(D, heads).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xpos),
        jnp.asarray(ypos))
    got, y_out = model.dec_blocks2[1](_t(x), _t(y), _t(xpos), _t(ypos))
    assert _rel(got.detach().numpy(), want) <= MODULE_REL
    assert torch.equal(y_out, _t(y))


@pytest.mark.parametrize("name,head_type", [
    ("downstream_head1", "regression"),
    ("downstream_head_dynamic_mask2", "semseg")])
def test_dpt_head_matches_flax(weights, name, head_type):
    _, params, model = weights
    rng = np.random.default_rng(6)
    n = (H // 16) * (W // 16)
    dims = [TINY.enc_embed_dim] + [TINY.dec_embed_dim] * TINY.dec_depth
    toks = [_tokens(rng, n, d) for d in dims]
    nch = 4 if head_type == "regression" else 1
    want = jdpt.DPTHead(nch, head_type, (0, 2, 3, 4)).apply(
        {"params": params[name]}, [jnp.asarray(t) for t in toks], H, W)
    got = getattr(model, name)([_t(t) for t in toks], H, W)
    assert got.shape == (2, H, W, nch)
    assert _rel(got.detach().numpy(), want) <= MODULE_REL


def test_linear_head_matches_flax():
    rng = np.random.default_rng(7)
    D, ch, p = 32, 4, 16
    head = tdpt.LinearHead(D, ch, p)
    w = rng.standard_normal((ch * p * p, D)).astype(np.float32) * 0.05
    b = rng.standard_normal(ch * p * p).astype(np.float32)
    head.load_state_dict({"proj.weight": _t(w), "proj.bias": _t(b)})
    toks = [_tokens(rng, (H // p) * (W // p), D)]
    want = jdpt.LinearHead(ch, p).apply(
        {"params": {"proj_shuffle": {"proj": {"kernel": w.T, "bias": b}}}},
        [jnp.asarray(t) for t in toks], H, W)
    got = head([_t(t) for t in toks], H, W)
    assert _rel(got.detach().numpy(), want) <= MODULE_REL


def test_resize_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 4, 6, 9))
    x = x.astype(np.float32)
    want = jdpt.resize_bilinear_ac(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   12, 18)
    got = tdpt.resize_bilinear_ac(_t(x), 12, 18).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# the whole model


@pytest.mark.parametrize("portrait", [False, True])
def test_forward_matches_jax(weights, portrait):
    """Landscape, and a portrait pair stored transposed in landscape
    buffers (ManyAR): maps in the buffer layout."""
    _, params, model = weights
    i1, i2 = _images(10 + portrait)
    want = JModel(JTINY).apply({"params": params}, jnp.asarray(i1),
                               jnp.asarray(i2), portrait1=portrait,
                               portrait2=portrait)
    with torch.no_grad():
        got = model(_t(i1), _t(i2), portrait1=portrait, portrait2=portrait)
    for g, w in zip(got, want):
        _assert_res(g, w)


def test_encode_decode_equals_forward(weights):
    _, _, model = weights
    i1, i2 = _images(12)
    with torch.no_grad():
        r1, r2 = model(_t(i1), _t(i2))
        f1, p1 = model.encode(_t(i1))
        f2, p2 = model.encode(_t(i2))
        q1, q2 = model.decode(f1, p1, f2, p2, H, W)
    for a, b in ((r1, q1), (r2, q2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_apply_manyar_mixed_batch_matches_jax(weights):
    """Rows 0 and 2 landscape, rows 1 and 3 portrait stored transposed:
    the host grouping returns landscape-layout maps in input order."""
    _, params, model = weights
    h, w = H, W
    i1, i2 = _images(13, n=4, h=h, w=w)
    ts = np.asarray([[h, w], [w, h], [h, w], [w, h]])
    want = jinference.apply_manyar(JModel(JTINY), params, jnp.asarray(i1),
                                   jnp.asarray(i2), ts, ts)
    with torch.no_grad():
        got = tinference.apply_manyar(model, _t(i1), _t(i2), ts, ts)
    assert got[0]["pts3d"].shape == (4, h, w, 3)
    for g, wr in zip(got, want):
        _assert_res(g, wr)


def test_bf16_trunk_close_to_float32(weights):
    """A bfloat16 trunk with float32 heads, within the JAX package's own
    bar of float32 (tests/test_croco_model.py:152)."""
    sd, _, model = weights
    m16 = AsymmetricCroCo3D(dataclasses.replace(TINY, dtype=torch.bfloat16))
    convert.load_reference_state_dict(m16, sd)
    assert m16.enc_blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert m16.enc_blocks[0].norm1.weight.dtype == torch.float32
    assert m16.decoder_embed.weight.dtype == torch.float32
    i1, i2 = _images(8, n=1)
    with torch.no_grad():
        r32, _ = model(_t(i1), _t(i2))
        r16, _ = m16(_t(i1), _t(i2))
    assert r16["pts3d"].dtype == torch.float32
    d = (r16["dynamic_mask"] - r32["dynamic_mask"]).abs()
    assert float(d.mean()) < 0.05
    rel = ((r16["pts3d"] - r32["pts3d"]).abs()
           / (r32["pts3d"].abs() + 1e-3))
    assert float(rel.median()) < 0.1


# ---------------------------------------------------------------------------
# weights


def _model_keys():
    return list(AsymmetricCroCo3D(TINY).state_dict())


@pytest.mark.parametrize("name", ["tiny", "large"])
def test_config_read_from_state_dict(name):
    """Widths, depths and patch from the keys and shapes; head counts from
    the checkpoint's args.model, else a head width of 64."""
    cfg = {"tiny": TINY, "large": DUST3R_LARGE_CONFIG}[name]
    with torch.device("meta"):
        sd = AsymmetricCroCo3D(cfg).state_dict()
    call = (f"AsymmetricCroCo3DStereo(pos_embed='RoPE100', "
            f"enc_num_heads={cfg.enc_num_heads}, "
            f"dec_num_heads={cfg.dec_num_heads})")
    assert convert.config_from_state_dict(sd, call) == cfg
    assert convert.config_from_state_dict(sd) == dataclasses.replace(
        cfg, enc_num_heads=cfg.enc_embed_dim // 64,
        dec_num_heads=cfg.dec_embed_dim // 64)


def test_weights_round_trip_through_jax_bitwise():
    sd = random_torch_state_dict(TINY, np.random.default_rng(1))
    back = convert.state_dict_from_jax_params(
        convert_torch_state_dict(sd, JTINY), TINY)
    keys = _model_keys()
    assert sorted(back) == sorted(keys)
    for k in keys:
        assert back[k].numpy().dtype == sd[k].dtype
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    # the reference keys the port's modules leave out: refinenet4's dead
    # unit only
    assert sorted(set(sd) - set(keys)) == sorted(
        f"{h}.dpt.scratch.refinenet4.resConfUnit1.{c}.{p}"
        for h in convert.HEADS for c in ("conv1", "conv2")
        for p in ("weight", "bias"))


def test_reference_quirks_load_as_in_jax():
    """``layerN_rn`` aliases in place of ``layer_rn.N`` and no
    ``dec_blocks2``: the port loads what the JAX converter makes of the
    same dict, bitwise."""
    sd = random_torch_state_dict(TINY, np.random.default_rng(2))
    alias = {}
    for k, v in sd.items():
        if k.startswith("dec_blocks2."):
            continue
        for i in range(4):
            k = k.replace(f".dpt.scratch.layer_rn.{i}.",
                          f".dpt.scratch.layer{i + 1}_rn.")
        alias[k] = v
    alias["an.extra.key"] = np.zeros(3, np.float32)
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, alias)
    want = convert.state_dict_from_jax_params(
        convert_torch_state_dict(alias, JTINY), TINY)
    got = model.state_dict()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["dec_blocks2.3.mlp.fc2.weight"],
                       _t(sd["dec_blocks.3.mlp.fc2.weight"]))
    assert torch.equal(got["downstream_head2.dpt.scratch.layer_rn.1.weight"],
                       _t(sd["downstream_head2.dpt.scratch.layer_rn.1."
                             "weight"]))
    del alias["dec_norm.bias"]
    with pytest.raises(KeyError, match="dec_norm.bias"):
        convert.load_reference_state_dict(AsymmetricCroCo3D(TINY), alias)


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_torch_checkpoint(tmp_path, wrapped):
    sd = random_torch_state_dict(TINY, np.random.default_rng(3))
    state = {k: _t(v) for k, v in sd.items()}
    path = tmp_path / "ckpt.pth"
    torch.save({"model": state, "epoch": 3} if wrapped else state, path)
    got = convert.load_torch_checkpoint(str(path))
    assert sorted(got) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])
