"""PyTorch port: entry-stream binning against the JAX package.

Both binners get the SAME preprocess outputs (the JAX ones, converted), so
the comparison is of binning alone and is bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import binning as jbin
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.ops.splat import binning as tbin
from das3r_tpu_torch.ops.splat.preprocess import Preprocessed

from test_splat import make_scene
from test_torch_preprocess import raster_kwargs, run_both_preprocess, \
    settings_pair

torch.set_num_threads(2)


def jax_prep_pair(n, seed, spread=1.5, **kw):
    """(JAX settings, port settings, JAX Preprocessed, the same as torch)."""
    rng = np.random.default_rng(seed)
    js, ts = settings_pair(**kw)
    means, scales, rots, ops, colors = make_scene(n, rng, spread=spread)
    want, _ = run_both_preprocess(
        js, ts, means, ops, raster_kwargs(js, scales, rots, colors=colors))
    prep_t = Preprocessed(*(torch.as_tensor(np.array(x)) for x in want))
    return js, ts, want, prep_t


def assert_streams_equal(jes, tes, n, n_tiles):
    """Port stream == the JAX stream's prefix; the JAX rest is void."""
    e = tes.rank.numel()
    jrank = np.asarray(jes.rank)
    jct = np.asarray(jes.chunk_tile)
    assert jrank.size >= e
    np.testing.assert_array_equal(tes.order.numpy(), np.asarray(jes.order))
    np.testing.assert_array_equal(tes.count.numpy(), np.asarray(jes.count))
    np.testing.assert_array_equal(tes.rank.numpy(), jrank[:e])
    np.testing.assert_array_equal(tes.chunk_tile.numpy(),
                                  jct[:e // tbin.CHUNK])
    assert (jrank[e:] == n).all()
    assert (jct[e // tbin.CHUNK:] == n_tiles).all()
    assert int(tes.entry_overflow) == int(jes.entry_overflow)
    assert int(tes.dup_overflow) == int(jes.dup_overflow)


@pytest.mark.parametrize("case", [
    dict(n=1500, seed=0, image_height=96, image_width=128,
         max_tiles_per_gaussian=32),
    dict(n=2000, seed=1, spread=0.6, image_height=64, image_width=80,
         max_tiles_per_gaussian=64, tight_binning=False),
    dict(n=700, seed=2, image_height=72, image_width=40,
         max_tiles_per_gaussian=8),
])
def test_bin_entry_stream_matches_jax(case):
    case = dict(case)
    n, seed, spread = case.pop("n"), case.pop("seed"), case.pop("spread", 1.5)
    js, ts, jprep, tprep = jax_prep_pair(n, seed, spread, sh_degree=0,
                                         max_total_entries=200_000, **case)
    jes = jax.jit(lambda p: jbin.bin_entry_stream(p, js))(jprep)
    tes = tbin.bin_entry_stream(tprep, ts)
    assert_streams_equal(jes, tes, n, ts.n_tiles)
    # the port's own invariants: aligned segments, void tail, no drop
    assert int(tes.entry_overflow) == 0
    al = (tes.count.long() + 127) // 128 * 128
    np.testing.assert_array_equal(tes.astart.numpy(),
                                  (torch.cumsum(al, 0) - al).numpy())
    assert tes.rank.numel() == max(int(al.sum()), 128)


@pytest.mark.parametrize("compact", [True, False])
def test_capped_stream_drops_farthest_like_jax(compact):
    """A set ``max_total_entries`` below the live count: the port keeps the
    JAX package's static stream size, drop policy and overflow report."""
    js, ts, jprep, tprep = jax_prep_pair(
        1200, 3, image_height=64, image_width=96, sh_degree=0,
        max_tiles_per_gaussian=32, max_total_entries=2048)
    if compact:
        js = dataclasses.replace(js, full_sort_below=0)
    ts = dataclasses.replace(ts, max_total_entries=js.max_total_entries,
                             full_sort_below=js.full_sort_below)
    n = tprep.depth.shape[0]
    assert tbin.entry_stream_cap(ts, n) == jbin.entry_stream_cap(js, n)
    jes = jax.jit(lambda p: jbin.bin_entry_stream(p, js))(jprep)
    tes = tbin.bin_entry_stream(tprep, ts)
    assert int(tes.entry_overflow) > 0
    assert tes.rank.numel() == np.asarray(jes.rank).size
    assert_streams_equal(jes, tes, n, ts.n_tiles)


def test_extract_chunks_plain_matches_pallas_kernel():
    """Plain ``extract_chunks`` == the Pallas chunk gather (interpret mode)
    followed by the JAX rank decode, bitwise."""
    rng = np.random.default_rng(4)
    n, n_live = 3000, 5000
    nbits = tbin.rank_bits(n)
    keys = np.sort(rng.choice(2**31 - 1, n_live, replace=False))
    # the JAX stream pads with a sentinel past the last 128-row
    e_pad = -(-n_live // 128) * 128 + 256
    keys_j = np.full(e_pad, 2**32 - 1, np.uint32)
    keys_j[:n_live] = keys
    src0 = rng.integers(0, n_live - 128, 48)
    src0[:4] = [0, 127, 128 * 7 + 127, n_live - 128]   # delta 0, 127, last
    nlive = rng.integers(0, 129, 48).astype(np.int32)
    nlive[:4] = [128, 128, 1, 128]
    nlive[4:6] = 0

    win = np.asarray(jbin._extract_chunks_pallas(
        jnp.asarray(keys_j.reshape(-1, 128)), jnp.asarray(src0 // 128),
        jnp.asarray(src0 % 128)))
    np.testing.assert_array_equal(
        win, keys_j[src0[:, None] + np.arange(128)])
    live = np.arange(128)[None, :] < nlive[:, None]
    want = np.where(live, np.minimum(
        (win & np.uint32((1 << nbits) - 1)).astype(np.int32), n - 1), n)
    got = tbin.extract_chunks(torch.as_tensor(keys.astype(np.int64)),
                              torch.as_tensor(src0), torch.as_tensor(nlive),
                              nbits, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1))


@pytest.mark.parametrize("nbits", [1, 12, 23])
def test_int64_keys_lift_the_32_bit_limit(nbits):
    """1080p (8160 tiles) with up to 5M Gaussians: the packed key stays
    below 2^63 and the rank mask recovers every rank."""
    s = RasterSettings(image_height=1080, image_width=1920)
    n = 5_000_000 if nbits == 23 else 2 ** (nbits - 1) + 1
    assert tbin.rank_bits(n) == nbits
    assert tbin.entry_stream_supported(n, s)
    if nbits == 23:   # the JAX package's u32 key cannot hold this one
        js, _ = settings_pair(image_height=1080, image_width=1920)
        assert not jbin.entry_stream_supported(n, js)
    rng = np.random.default_rng(nbits)
    tile = torch.as_tensor(rng.integers(0, s.n_tiles + 1, 4096))
    rank = torch.as_tensor(rng.integers(0, n, 4096))
    rank[:2] = torch.tensor([0, n - 1])
    tile[:2] = torch.tensor([s.n_tiles, 0])
    keys = torch.sort((tile << nbits) | rank).values
    assert int(keys.max()) < 2**63 - 1 and int(keys.min()) >= 0
    src0 = torch.arange(0, 4096, 128)
    nlive = torch.full((32,), 128, dtype=torch.int32)
    got = tbin.extract_chunks(keys, src0, nlive, nbits, n)
    np.testing.assert_array_equal(
        got.numpy(), (keys & ((1 << nbits) - 1)).numpy())
    np.testing.assert_array_equal((keys >> nbits).numpy(),
                                  torch.sort(tile).values.numpy())


def test_empty_scene_gives_one_void_chunk():
    _, ts, _, tprep = jax_prep_pair(10, 5, image_height=32, image_width=32,
                                    sh_degree=0)
    tprep = tprep._replace(binnable=torch.zeros_like(tprep.binnable))
    es = tbin.bin_entry_stream(tprep, ts)
    assert es.rank.numel() == 128 and (es.rank == 10).all()
    assert (es.chunk_tile == ts.n_tiles).all() and int(es.count.sum()) == 0
