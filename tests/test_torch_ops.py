"""The port's ORB front end and matcher against the JAX package, module by
module, on the same inputs: pyramid and blur, BRIEF tables, the three
kernels' plain versions against the JAX CPU routes (rank_map_xla,
gather_patches, hamming_matrix + top2_min), extract_batch as a whole,
undistortion and the numpy scene renderer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu.ops import brief as jbrief
from aria_slam_tpu.ops import fast as jfast
from aria_slam_tpu.ops import match as jmatch
from aria_slam_tpu.ops import orb as jorb
from aria_slam_tpu.ops import orient as jorient
from aria_slam_tpu.ops import pyramid as jpyramid
from aria_slam_tpu.ops import undistort as jundistort
from aria_slam_tpu_torch.ops import brief as tbrief
from aria_slam_tpu_torch.ops import orb as torb
from aria_slam_tpu_torch.ops import orient as torient
from aria_slam_tpu_torch.ops import pyramid as tpyramid
from aria_slam_tpu_torch.ops import undistort as tundistort
from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel

from torch_parity_util import JAX_SMALL_CFG, TORCH_SMALL_CFG, rendered_frames


@pytest.fixture(scope="module")
def frames():
    return rendered_frames(2)  # (2, 240, 320) float32, integer grey levels


# --------------------------------------------------------- pyramid, blur
def test_pyramid_and_brief_blur_match(frames):
    cfg = JAX_SMALL_CFG.orb
    jl = jpyramid.build_pyramid(jnp.asarray(frames), 4, cfg.scale_factor)
    tl = tpyramid.build_pyramid(torch.from_numpy(frames), 4, cfg.scale_factor)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    for a, b in zip(jl, tl):
        # both round the same bf16 operands; only the summation order differs
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-3
        jb = np.asarray(jbrief.smooth_for_brief(a))
        assert np.abs(jb - tbrief.smooth_for_brief(b).numpy()).max() <= 1e-3


def test_brief_tables_are_byte_identical():
    cfg = TORCH_SMALL_CFG.orb
    jp = jbrief.brief_pattern(cfg.descriptor_bits, cfg.patch_size, cfg.brief_seed)
    tp = tbrief.brief_pattern(cfg.descriptor_bits, cfg.patch_size, cfg.brief_seed)
    assert jp.tobytes() == tp.tobytes()
    assert jbrief._selection_matrix(jp).tobytes() == tbrief._selection_matrix(tp).tobytes()
    assert jbrief._moment_matrix().tobytes() == tbrief._moment_matrix().tobytes()
    for n_out, n_in in ((200, 240), (167, 200)):
        assert (jpyramid._bilinear_matrix(n_out, n_in).tobytes()
                == tpyramid._bilinear_matrix(n_out, n_in).tobytes())
    assert jpyramid._box_matrix(50, 5).tobytes() == tpyramid._box_matrix(50, 5).tobytes()


def test_describe_and_orient_matches(frames):
    rng = np.random.default_rng(5)
    pattern = tbrief.brief_pattern()
    patches = np.round(rng.uniform(0, 255, (2, 64, tbrief.PATCH_S ** 2))).astype(np.float32)
    jd, ja = jbrief.describe_and_orient(jnp.asarray(patches), pattern)
    td, ta = tbrief.describe_and_orient(torch.from_numpy(patches), pattern)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), atol=1e-5)


def test_describe_and_orient_once_equals_per_level(frames):
    """extract_batch's one BRIEF product over every level's patches gives
    the bits of one product a level: each bit is the difference of two
    bf16-rounded pixels, exact in any summation order. Only the two
    orientation moments (sums of ~700 terms) may round differently; the
    angles agree to 1e-5 rad and no steering bin changes on these frames."""
    cfg = TORCH_SMALL_CFG.orb
    levels = tpyramid.build_pyramid(torch.from_numpy(frames), cfg.num_levels, cfg.scale_factor)
    ranks = corner_kernel.corner_rank_maps(levels, cfg.fast_threshold, cfg.harris_block_size)
    quotas = torb.features_per_level(cfg.num_features, cfg.num_levels, cfg.scale_factor)
    xys = [torb._select_keypoints(rank, q, cfg.edge_threshold)[0]
           for rank, q in zip(ranks, quotas)]
    blurred = [tbrief.smooth_for_brief(lvl) for lvl in levels]
    pattern = tbrief.brief_pattern(cfg.descriptor_bits, cfg.patch_size, cfg.brief_seed)
    patches = patch_kernel.extract_patches_levels(blurred, xys, tbrief.PATCH_R)
    once_d, once_a = tbrief.describe_and_orient(patches.flatten(2), pattern)
    per = [tbrief.describe_and_orient(
        patch_kernel.extract_patches(img, xy, tbrief.PATCH_R).flatten(2), pattern)
        for img, xy in zip(blurred, xys)]
    per_d, per_a = torch.cat([d for d, _ in per], 1), torch.cat([a for _, a in per], 1)
    assert once_d.shape == (2, cfg.num_features, cfg.descriptor_bits)
    assert torch.equal(tbrief.angle_bin(once_a), tbrief.angle_bin(per_a))
    assert torch.equal(once_d, per_d)
    np.testing.assert_allclose(once_a.numpy(), per_a.numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------------------ corner map
@pytest.mark.parametrize("level", [0, 1, 2])
def test_corner_plain_matches_rank_map_xla(frames, level):
    """The gates of tests_tpu/parity.py: interior (16-px margin) mask
    agreement > 0.9995, corner-set IoU > 0.99, Harris rel diff < 1e-3.
    The XLA map zero-pads its box sums, the kernel edge-replicates."""
    cfg = TORCH_SMALL_CFG.orb
    lvl = tpyramid.build_pyramid(torch.from_numpy(frames), 3, cfg.scale_factor)[level]
    ours = corner_kernel.corner_rank_map_batched(lvl, cfg.fast_threshold,
                                                 cfg.harris_block_size).numpy()
    ref = np.asarray(jax.vmap(lambda im: jfast.rank_map_xla(
        im, cfg.fast_threshold, cfg.harris_block_size))(jnp.asarray(lvl.numpy())))
    m = 16
    ours, ref = ours[:, m:-m, m:-m], ref[:, m:-m, m:-m]
    mo, mr = ours > -1e38, ref > -1e38
    assert (mo == mr).mean() > 0.9995
    assert (mo & mr).sum() / max((mo | mr).sum(), 1) > 0.99
    both = mo & mr
    rel = np.abs(ours[both] - ref[both]) / np.maximum(np.abs(ref[both]), 1.0)
    assert rel.max() < 1e-3


def test_rank_map_xla_matches(frames):
    """The port's copy of the reference's unfused, zero-padded corner map."""
    from aria_slam_tpu_torch.ops import fast as tfast

    cfg = TORCH_SMALL_CFG.orb
    img = frames[0]
    ours = tfast.rank_map_xla(torch.from_numpy(img), cfg.fast_threshold,
                              cfg.harris_block_size).numpy()
    ref = np.asarray(jfast.rank_map_xla(jnp.asarray(img), cfg.fast_threshold,
                                        cfg.harris_block_size))
    mo, mr = np.isfinite(ours), np.isfinite(ref)
    np.testing.assert_array_equal(mo, mr)
    assert mo.sum() > 100
    np.testing.assert_allclose(ours[mo], ref[mr], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tfast.fast_score_map(torch.from_numpy(img), 20.0).numpy(),
                               np.asarray(jfast.fast_score_map(jnp.asarray(img), 20.0)))


def test_corner_plain_edge_replicates():
    """The plain version is the kernel's function: computed on the image
    edge-replicated in every direction (an image padded by replication
    gives the same interior map)."""
    rng = np.random.default_rng(2)
    img = torch.from_numpy(np.round(rng.uniform(0, 255, (1, 40, 56))).astype(np.float32))
    padded = corner_kernel._edge_pad(img, 5)
    a = corner_kernel.corner_rank_map_plain(img, 20.0)
    b = corner_kernel.corner_rank_map_plain(padded, 20.0)[:, 5:-5, 5:-5]
    assert torch.equal(a, b)
    assert (a > -1e38).sum() > 20


# ----------------------------------------------------------------- patch
def test_patch_plain_matches_gather_patches(frames):
    """Exactly equal at keypoints inside ORB's 31-px border, where the
    kernel's corner clamp and gather_patches' centre clamp agree."""
    img = tbrief.smooth_for_brief(torch.from_numpy(frames))
    h, w = img.shape[-2:]
    rng = np.random.default_rng(3)
    border = TORCH_SMALL_CFG.orb.edge_threshold
    xy = np.stack([rng.uniform(border, w - border - 1, (2, 300)),
                   rng.uniform(border, h - border - 1, (2, 300))], -1).astype(np.float32)
    ours = patch_kernel.extract_patches(img, torch.from_numpy(xy), tbrief.PATCH_R)
    ref = jax.vmap(lambda im, p: jorient.gather_patches(im, p, jbrief.PATCH_R))(
        jnp.asarray(img.numpy()), jnp.asarray(xy))
    np.testing.assert_array_equal(np.asarray(ref), ours.numpy())
    # the port's gather_patches itself, centres anywhere (its centre clamp)
    xy_any = np.stack([rng.uniform(-5, w + 5, 200), rng.uniform(-5, h + 5, 200)],
                      -1).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jorient.gather_patches(jnp.asarray(img[0].numpy()), jnp.asarray(xy_any),
                                          jbrief.PATCH_R)),
        torient.gather_patches(img[0], torch.from_numpy(xy_any), tbrief.PATCH_R).numpy())


def test_patch_plain_clamps_the_corner():
    img = torch.arange(20 * 30, dtype=torch.float32).reshape(1, 20, 30)
    xy = torch.tensor([[[0.0, 0.0], [29.0, 19.0], [29.6, 2.0]]])
    p = patch_kernel.extract_patches(img, xy, 2)
    assert torch.equal(p[0, 0], img[0, 0:5, 0:5])      # corner clipped to 0
    # corner (27, 17): rows 17..19 then the last row repeated; same for columns
    rows = torch.tensor([17, 18, 19, 19, 19])
    cols = torch.tensor([27, 28, 29, 29, 29])
    assert torch.equal(p[0, 1], img[0][rows][:, cols])
    # round(29.6) = 30 -> corner x = 28; rows 0..4
    assert torch.equal(p[0, 2], img[0, 0:5][:, torch.tensor([28, 29, 29, 29, 29])])


# ----------------------------------------------------------------- match
def _bits(rng, *shape):
    return rng.integers(0, 2, shape).astype(np.int8)


def _match_cases():
    rng = np.random.default_rng(7)
    q, t = _bits(rng, 2, 300, 256), _bits(rng, 2, 777, 256)
    yield "ragged", q, t, rng.random((2, 777)) > 0.1
    q, t = _bits(rng, 1, 200, 256), _bits(rng, 1, 260, 256)
    t[:, :100] = q[:, :100]
    t[:, 100:200] = q[:, :100]      # every query twice: a tie at distance 0
    yield "duplicates", q, t, np.ones((1, 260), bool)
    q = _bits(rng, 1, 50, 256)
    t = np.repeat(_bits(rng, 1, 1, 256), 90, axis=1)  # all columns equal
    yield "all_ties", q, t, rng.random((1, 90)) > 0.3
    yield "all_invalid", _bits(rng, 1, 40, 256), _bits(rng, 1, 64, 256), np.zeros((1, 64), bool)
    yield "kt1", _bits(rng, 3, 33, 256), _bits(rng, 3, 1, 256), np.ones((3, 1), bool)
    q = np.zeros((1, 10, 256), np.int8)
    t = np.ones((1, 5, 256), np.int8)   # distance 256 everywhere, below the clip
    yield "max_distance", q, t, np.ones((1, 5), bool)


@pytest.mark.parametrize("name,q,t,v", list(_match_cases()),
                         ids=[c[0] for c in _match_cases()])
def test_match_plain_bit_exact(name, q, t, v):
    ours = match_kernel.match_top2_batched(torch.from_numpy(q), torch.from_numpy(t),
                                           torch.from_numpy(v))
    for n in range(q.shape[0]):
        d = jmatch.hamming_matrix(jnp.asarray(q[n]), jnp.asarray(t[n]), jnp.asarray(v[n]))
        ref = jmatch.top2_min(d)
        for a, b in zip(ref, ours):
            np.testing.assert_array_equal(np.asarray(a), b[n].numpy(), err_msg=name)
    best, second, idx = (x.numpy() for x in ours)
    if name == "all_invalid":
        assert (best == 1 << 20).all() and (second == 1 << 20).all() and (idx == 0).all()
    if name == "kt1":
        assert (second == 1 << 20).all()
    if name == "duplicates":
        assert (best[0, :100] == 0).all() and (second[0, :100] == 0).all()
        np.testing.assert_array_equal(idx[0, :100], np.arange(100))


def test_match_with_ratio_gate_matches(frames):
    from aria_slam_tpu_torch.ops import match as tmatch

    jf = jorb.extract_batch(jnp.asarray(frames), JAX_SMALL_CFG.orb)
    q = jax.tree_util.tree_map(lambda x: x[1], jf)
    t = jax.tree_util.tree_map(lambda x: x[0], jf)
    ref = jmatch.match(q, t, 0.75)
    from aria_slam_tpu_torch.convert import features_from_numpy

    tq = features_from_numpy(jax.tree_util.tree_map(np.asarray, q), "cpu")
    tt = features_from_numpy(jax.tree_util.tree_map(np.asarray, t), "cpu")
    ours = tmatch.match(tq, tt, 0.75)
    for f in ("query_idx", "train_idx", "distance", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), getattr(ours, f).numpy())
    assert int(ours.valid.sum()) > 50
    batched_ref = jmatch.match_batched(jax.tree_util.tree_map(lambda x: x[1:], jf),
                                       jax.tree_util.tree_map(lambda x: x[:1], jf), 0.75)
    tf = features_from_numpy(jax.tree_util.tree_map(np.asarray, jf), "cpu")
    batched = tmatch.match_batched(tf.map(lambda x: x[1:]), tf.map(lambda x: x[:1]), 0.75)
    for f in ("query_idx", "train_idx", "distance", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(batched_ref, f)),
                                      getattr(batched, f).numpy())
    cc_ref = jmatch.match(q, t, 0.75, cross_check=True)
    cc = tmatch.match(tq, tt, 0.75, cross_check=True)
    np.testing.assert_array_equal(np.asarray(cc_ref.valid), cc.valid.numpy())


def test_pack_bits_matches():
    rng = np.random.default_rng(8)
    d = _bits(rng, 17, 256)
    ref = np.asarray(jbrief.pack_bits(jnp.asarray(d))).astype(np.int64)
    np.testing.assert_array_equal(ref, tbrief.pack_bits(torch.from_numpy(d)).numpy())


# ------------------------------------------------------------ extract
def test_extract_batch_matches(frames):
    """tests_tpu/parity.py's extract gates: keypoint-set IoU > 0.97,
    descriptor Hamming mean < 4 and p99 <= 24 over common keypoints."""
    jf = jorb.extract_batch(jnp.asarray(frames), JAX_SMALL_CFG.orb)
    tf = torb.extract_batch(torch.from_numpy(frames), TORCH_SMALL_CFG.orb)
    jxy, jdesc, jval = (np.asarray(x) for x in (jf.xy, jf.desc, jf.valid))
    txy, tdesc, tval = tf.xy.numpy(), tf.desc.numpy(), tf.valid.numpy()
    assert txy.shape == jxy.shape and tdesc.shape == jdesc.shape
    np.testing.assert_array_equal(np.asarray(jf.octave), tf.octave.numpy())
    np.testing.assert_allclose(np.asarray(jf.size), tf.size.numpy())
    ious, dists = [], []
    for b in range(frames.shape[0]):
        jmap = {tuple(v): i for i, v in enumerate(np.round(jxy[b] * 8).astype(int)) if jval[b][i]}
        tmap = {tuple(v): i for i, v in enumerate(np.round(txy[b] * 8).astype(int)) if tval[b][i]}
        common = set(jmap) & set(tmap)
        ious.append(len(common) / max(len(set(jmap) | set(tmap)), 1))
        dists += [int((jdesc[b][jmap[c]] != tdesc[b][tmap[c]]).sum()) for c in common]
    dists = np.asarray(dists)
    assert min(ious) > 0.97, ious
    assert dists.mean() < 4.0 and np.percentile(dists, 99) <= 24, (dists.mean(),
                                                                   np.percentile(dists, 99))
    assert tval.sum() > 0.9 * tval.size


def test_jax_cpu_approx_max_k_is_exact(frames):
    """The port's exact torch.topk stands in for approx_max_k: on the CPU
    JAX's approx_max_k returns the exact top-k of these rank maps."""
    cfg = JAX_SMALL_CFG.orb
    levels = jpyramid.build_pyramid(jnp.asarray(frames), cfg.num_levels, cfg.scale_factor)
    quotas = jorb.features_per_level(cfg.num_features, cfg.num_levels, cfg.scale_factor)
    for lvl, k in zip(levels, quotas):
        rank = jax.vmap(lambda im: jfast.rank_map_xla(im, cfg.fast_threshold,
                                                      cfg.harris_block_size))(lvl)
        flat = rank.reshape(rank.shape[0], -1)
        av, ai = jax.lax.approx_max_k(flat, k, recall_target=0.95)
        ev, ei = jax.lax.top_k(flat, k)
        np.testing.assert_array_equal(np.asarray(av), np.asarray(ev))
        tv, _ = torch.topk(torch.from_numpy(np.array(flat)), k, dim=-1)
        np.testing.assert_array_equal(np.asarray(ev), tv.numpy())
    assert torb.features_per_level(2000, 8, 1.2) == jorb.features_per_level(2000, 8, 1.2)


# ---------------------------------------------------- undistort, render
def test_undistort_matches():
    from aria_slam_tpu.config import CameraConfig as JCam
    from aria_slam_tpu_torch.config import CameraConfig as TCam

    rng = np.random.default_rng(9)
    xy = np.stack([rng.uniform(0, 752, 500), rng.uniform(0, 480, 500)], -1).astype(np.float32)
    ref = np.asarray(jundistort.undistort_points(jnp.asarray(xy), JCam()))
    np.testing.assert_allclose(ref, tundistort.undistort_points(torch.from_numpy(xy),
                                                                TCam()).numpy(), atol=1e-3)


def test_numpy_renderer_matches_reference():
    """The port renders without OpenCV; frames agree with the reference's
    cv2 warps to about one grey level."""
    from aria_slam_tpu.io import synthetic_scene as jscene
    from aria_slam_tpu_torch.io import synthetic_scene as tscene

    cam = TORCH_SMALL_CFG.camera
    layers_j, layers_t = jscene.scene_layers(4.0, 0), tscene.scene_layers(4.0, 0)
    for (cj, tj), (ct, tt) in zip(layers_j, layers_t):
        np.testing.assert_array_equal(cj, ct)
        np.testing.assert_array_equal(tj, tt)
    for t in (0.0, 0.7):
        pos, R = tscene.trajectory(t)
        a = jscene.render_frame(JAX_SMALL_CFG.camera, None, pos, R, layers=layers_j)
        b = tscene.render_frame(cam, None, pos, R, layers=layers_t)
        diff = np.abs(a.astype(int) - b.astype(int))
        assert np.mean(diff <= 1) > 0.99 and diff.mean() < 0.3, (np.mean(diff <= 1), diff.mean())
