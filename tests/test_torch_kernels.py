"""The kernels' plain versions against the Pallas kernels themselves, and
the rules the CUDA kernels add on top of them.

Each Pallas kernel of the JAX package (ops/pallas/) runs here in TPU
interpret mode: `pl.pallas_call` is patched inside the test to pass
`interpret=pltpu.InterpretParams()`, and nothing in the JAX package
changes. The same numpy inputs go through the kernel and through the
port's plain version, which is what the CUDA kernels are held to on the
card. Besides: `corner_rank_maps` and `extract_patches_levels` (all
pyramid levels in one call) on the CPU, the patch kernel's level table
(`level_plan`) and a copy of its per-block arithmetic, the split of the train columns
that the match kernel makes to fill the card (`split_plan`), and the rule
that merges the slices' results.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aria_slam_tpu.ops.pallas import corner_kernel as jcorner
from aria_slam_tpu.ops.pallas import match_kernel as jmatch
from aria_slam_tpu.ops.pallas import patch_kernel as jpatch
from aria_slam_tpu_torch.ops import orb as torb
from aria_slam_tpu_torch.ops import pyramid as tpyramid
from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel

from torch_parity_util import TORCH_SMALL_CFG

BIG = match_kernel.BIG


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call of the test in TPU interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()))


def _bits(rng, *shape):
    return rng.integers(0, 2, shape).astype(np.int8)


def _match_cases():
    """(name, desc_q, desc_t, valid_t) with ties, clips and sentinels."""
    rng = np.random.default_rng(11)
    yield "random", _bits(rng, 2, 37, 256), _bits(rng, 2, 70, 256), rng.random((2, 70)) > 0.1
    q, t = _bits(rng, 1, 40, 256), _bits(rng, 1, 52, 256)
    t[:, :20] = q[:, :20]
    t[:, 20:40] = q[:, :20]         # every query of the first 20 twice: tie at 0
    yield "dups", q, t, np.ones((1, 52), bool)
    t = np.repeat(_bits(rng, 1, 1, 256), 30, axis=1)  # all columns equal
    yield "all_ties", _bits(rng, 1, 25, 256), t, rng.random((1, 30)) > 0.3
    yield "all_invalid", _bits(rng, 1, 20, 256), _bits(rng, 1, 33, 256), np.zeros((1, 33), bool)
    yield "kt1", _bits(rng, 3, 9, 256), _bits(rng, 3, 1, 256), np.ones((3, 1), bool)


MATCH_CASES = list(_match_cases())
MATCH_IDS = [c[0] for c in MATCH_CASES]


# ------------------------------------------------ plain vs Pallas kernels
@pytest.mark.parametrize("name,q,t,v", MATCH_CASES, ids=MATCH_IDS)
def test_match_plain_matches_pallas_kernel(interpret, name, q, t, v):
    ref = jmatch.match_top2_batched(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v))
    ours = match_kernel.match_top2_plain(torch.from_numpy(q), torch.from_numpy(t),
                                         torch.from_numpy(v))
    for a, b, what in zip(ref, ours, ("best", "second", "best_idx")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{name} {what}")
    best, second, idx = (x.numpy() for x in ours)
    if name == "all_invalid":
        assert (best == BIG).all() and (second == BIG).all() and (idx == 0).all()
    if name == "kt1":
        assert (second == BIG).all()
    if name == "dups":
        assert (best[0, :20] == 0).all() and (second[0, :20] == 0).all()
        np.testing.assert_array_equal(idx[0, :20], np.arange(20))


def _edge_centres(rng, h, w, inside):
    """(2, 12 + inside, 2) float32 centres: past every edge and corner of
    an h x w image, on its border, and `inside` anywhere inside."""
    edge = [(-5, -5), (w + 5, -5), (-5, h + 5), (w + 5, h + 5), (w / 2, -7), (w / 2, h + 7),
            (-7, h / 2), (w + 7, h / 2), (0, 0), (w - 1, h - 1), (w - 0.6, 3), (2.4, h - 0.5)]
    pts = np.stack([rng.uniform(0, w, inside), rng.uniform(0, h, inside)], -1)
    return np.concatenate([np.array(edge), pts])[None].repeat(2, 0).astype(np.float32)


def test_patch_plain_matches_pallas_kernel(interpret):
    rng = np.random.default_rng(12)
    img = rng.uniform(0, 255, (2, 60, 80)).astype(np.float32)
    xy = _edge_centres(rng, *img.shape[1:], 12)  # 24 centres
    ref = jpatch.extract_patches(jnp.asarray(img), jnp.asarray(xy), 19)
    ours = patch_kernel.extract_patches_plain(torch.from_numpy(img), torch.from_numpy(xy), 19)
    np.testing.assert_array_equal(np.asarray(ref), ours.numpy())


def _patch_pyramid():
    """A 3-level pyramid of two random frames and ragged sets of edge and
    inside centres a level (19, 14 and 12 of them)."""
    rng = np.random.default_rng(14)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 60, 80)).astype(np.float32))
    levels = [lvl.contiguous() for lvl in tpyramid.build_pyramid(img, 3, 1.2)]
    xys = [torch.from_numpy(_edge_centres(rng, *lvl.shape[1:], n))
           for lvl, n in zip(levels, (7, 2, 0))]
    return levels, xys


def test_patch_levels_plain_matches_pallas_kernel(interpret):
    """All levels at once, as the CUDA kernel cuts them, against the Pallas
    kernel level by level, exactly."""
    levels, xys = _patch_pyramid()
    ref = np.concatenate([np.asarray(jpatch.extract_patches(jnp.asarray(lvl.numpy()),
                                                            jnp.asarray(xy.numpy()), 19))
                          for lvl, xy in zip(levels, xys)], 1)
    ours = patch_kernel.extract_patches_levels_plain(levels, xys, 19)
    assert ours.shape == (2, 19 + 14 + 12, 39, 39)
    np.testing.assert_array_equal(ref, ours.numpy())


def test_patch_levels_equals_per_level_calls():
    levels, xys = _patch_pyramid()
    got = patch_kernel.extract_patches_levels(levels, xys, 19)
    want = torch.cat([patch_kernel.extract_patches(lvl, xy, 19)
                      for lvl, xy in zip(levels, xys)], 1)
    assert torch.equal(got, want)
    assert patch_kernel.extract_patches_levels.launches == 0  # CPU tensors: plain version


def _block_ranges(keys, batch: int, radius: int):
    """What each block of csrc/patch_kernel.cu's grid does, in launch
    order, in a copy of the kernel's arithmetic (the kernel does not run
    this): (frame, level, first keypoint of the level, keypoints, output
    start in floats, head, float4s, tail), where head scalars reach the
    output's first 16-byte boundary, the float4s are aligned and the tail
    scalars follow them."""
    area = (2 * radius + 1) ** 2
    total = sum(keys)
    first_key = [0, *np.cumsum(keys).tolist()]
    out = []
    for frame in range(batch):
        for lvl, k in enumerate(keys):
            for k0 in range(0, k, patch_kernel.GROUP):
                n = min(patch_kernel.GROUP, k - k0)
                start = (frame * total + first_key[lvl] + k0) * area
                head = min((4 - start % 4) % 4, n * area)
                body = (n * area - head) // 4
                out.append((frame, lvl, k0, n, start, head, body, n * area - head - 4 * body))
    return out


@pytest.mark.parametrize("keys,batch", [
    (torb.features_per_level(2000, 8, 1.2), 1),
    (torb.features_per_level(2000, 8, 1.2), 33),
    ([5, 1, 0, 9, 4, 3], 3),   # ragged, with an empty level
], ids=["default_B1", "default_B33", "ragged"])
def test_patch_block_plan(keys, batch):
    """The level table's prefix sums and every block's share of the output:
    the blocks cover it once, in order, each storing aligned float4s
    between a head and a tail of at most 3 floats."""
    radius, area = 19, 39 * 39
    first_key, first_block = patch_kernel.level_plan(keys)
    assert first_key == [0, *np.cumsum(keys).tolist()]
    assert first_block == [0, *np.cumsum([-(-k // patch_kernel.GROUP) for k in keys]).tolist()]
    blocks = _block_ranges(keys, batch, radius)
    end = 0
    for frame, lvl, k0, n, start, head, body, tail in blocks:
        assert start == end and 1 <= n <= patch_kernel.GROUP and k0 + n <= keys[lvl]
        assert 0 <= head <= 3 and 0 <= tail <= 3 and head + 4 * body + tail == n * area
        assert body == 0 or (start + head) % 4 == 0
        end = start + n * area
    assert end == batch * sum(keys) * area
    assert len(blocks) == batch * first_block[-1]
    heads = {b[5] for b in blocks}
    if sum(keys) == 2000:
        assert heads == {0, 1, 2, 3}  # odd level offsets: every alignment occurs
        assert len(blocks) >= 2 * 132 * batch  # two blocks an SM at least, per frame


@pytest.mark.parametrize("shape", [(1, 70, 90), (2, 41, 130)])
def test_corner_plain_matches_pallas_kernel(interpret, shape):
    """Masks identical; Harris within 1e-6 relative (XLA's CPU rounding of
    the kernel's shifted adds differs from torch's by 1-2 ulp)."""
    rng = np.random.default_rng(13)
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    ref = np.asarray(jcorner.corner_rank_map_batched(jnp.asarray(img), 20.0))
    ours = corner_kernel.corner_rank_map_plain(torch.from_numpy(img), 20.0).numpy()
    mr, mo = ref > -1e38, ours > -1e38
    np.testing.assert_array_equal(mr, mo)
    assert mo.sum() > 50
    np.testing.assert_array_equal(ref[~mo], ours[~mo])
    rel = np.abs(ref[mo] - ours[mo]) / np.maximum(np.abs(ref[mo]), 1.0)
    assert rel.max() < 1e-6, rel.max()


# ------------------------------------------------------ corner_rank_maps
def test_corner_rank_maps_equals_per_level_plain():
    from torch_parity_util import rendered_frames

    cfg = TORCH_SMALL_CFG.orb
    levels = tpyramid.build_pyramid(torch.from_numpy(rendered_frames(1)), 3, cfg.scale_factor)
    maps = corner_kernel.corner_rank_maps(levels, cfg.fast_threshold, cfg.harris_block_size)
    assert len(maps) == 3
    for lvl, got in zip(levels, maps):
        want = corner_kernel.corner_rank_map_plain(lvl, cfg.fast_threshold,
                                                   cfg.harris_block_size)
        assert torch.equal(got, want)
        assert (got > -1e38).sum() > 20
    one = corner_kernel.corner_rank_map_batched(levels[1], cfg.fast_threshold,
                                                cfg.harris_block_size)
    assert torch.equal(one, maps[1])


# ------------------------------------------------ the match kernel's split
@pytest.mark.parametrize("n,kq,kt", [(1, 2000, 2000), (4, 2000, 2000), (256, 2000, 2000),
                                     (1, 5, 1001), (3, 65, 1), (2, 700, 1001)])
def test_split_plan(n, kq, kt):
    sms = 132
    slices, slice_len = match_kernel.split_plan(n, kq, kt, sms)
    assert slice_len % 64 == 0
    assert slices * slice_len >= kt > (slices - 1) * slice_len  # no empty slice
    blocks = n * -(-kq // match_kernel._QUERY_BLOCK) * slices
    if (n, kq) == (1, 2000):
        assert blocks >= sms
    if n == 256:
        assert slices == 1


def _merge_lexicographic(a, b):
    """Two (best, second, idx) results over disjoint column sets: the
    smaller (best, idx) wins, second = min(winner's second, loser's best)."""
    (ab, asec, ai), (bb, bsec, bi) = a, b
    a_wins = (ab < bb) | ((ab == bb) & (ai < bi))
    return (torch.where(a_wins, ab, bb),
            torch.where(a_wins, torch.minimum(asec, bb), torch.minimum(bsec, ab)),
            torch.where(a_wins, ai, bi))


def _merge_packed(a, b):
    """The same on packed keys (distance << 20 | column), as the kernel
    merges them: best = min of the bests, second = min(min of the seconds,
    max of the bests)."""
    (ab, asec), (bb, bsec) = a, b
    return torch.minimum(ab, bb), torch.minimum(torch.minimum(asec, bsec), torch.maximum(ab, bb))


def _split_top2(dist, slices, rule, tile=16):
    """top2_min of `dist` taken slice by slice over the columns, padded
    to slices * slice_len with invalid columns (some slices all padding),
    and merged by `rule`."""
    kt = dist.shape[-1]
    slice_len = -(-(-(-kt // slices)) // tile) * tile
    padded = torch.full(dist.shape[:-1] + (slices * slice_len,), BIG, dtype=dist.dtype)
    padded[..., :kt] = dist
    out = None
    for s in range(slices):
        part = padded[..., s * slice_len: (s + 1) * slice_len]
        if rule == "lexicographic":
            best, second, idx = match_kernel.top2_min(part)
            res = (best, second, idx + s * slice_len)
            out = res if out is None else _merge_lexicographic(out, res)
        else:
            cols = torch.arange(s * slice_len, (s + 1) * slice_len, dtype=torch.int32)
            keys = (torch.clamp(part, max=1 << 10) << 20) | cols
            k2 = torch.topk(keys, 2, dim=-1, largest=False).values
            res = (k2[..., 0], k2[..., 1])
            out = res if out is None else _merge_packed(out, res)
    if rule == "packed":
        def reported(k):
            v = k >> 20
            return torch.where(v >= 1 << 10, BIG, v)
        out = (reported(out[0]), reported(out[1]), out[0] & ((1 << 20) - 1))
    return out


@pytest.mark.parametrize("rule", ["lexicographic", "packed"])
@pytest.mark.parametrize("slices", [1, 3, 8])
@pytest.mark.parametrize("name", ["random", "dups", "all_invalid", "kt1"])
def test_split_merge_equals_unsplit_top2(name, slices, rule):
    """The merge rules, written out here in torch, give the unsplit result.
    This checks the rules, not the CUDA kernel's merges: those are held to
    the plain version on the card by chip_smoke.py."""
    _, q, t, v = MATCH_CASES[MATCH_IDS.index(name)]
    dist = match_kernel.hamming_matrix(torch.from_numpy(q), torch.from_numpy(t),
                                       torch.from_numpy(v))
    want = match_kernel.top2_min(dist)
    got = _split_top2(dist, slices, rule)
    for a, b, what in zip(got, want, ("best", "second", "best_idx")):
        assert torch.equal(a, b), f"{name} S={slices} {rule}: {what}"
