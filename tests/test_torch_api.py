"""The JAX package's remaining public functions against their ports, one
parametrised case a function, on the same numpy inputs (the JAX side on
the CPU, the port on CPU tensors): brief.describe, describe_from_patches
and unpack_bits, orient.orientations and orientations_from_patches,
fast.detect_level, pyramid.box_blur, match.hamming_matrix and top2_min,
yolo.init_params, native.available and profiling.device_trace. Each
case states its tolerance; the bit and integer outputs are exact."""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import native as jnative
from aria_slam_tpu.models import yolo as jyolo
from aria_slam_tpu.ops import brief as jbrief
from aria_slam_tpu.ops import fast as jfast
from aria_slam_tpu.ops import match as jmatch
from aria_slam_tpu.ops import orient as jorient
from aria_slam_tpu.ops import pyramid as jpyramid
from aria_slam_tpu.utils import profiling as jprofiling
from aria_slam_tpu_torch import native as tnative
from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.models import yolo as tyolo
from aria_slam_tpu_torch.ops import brief as tbrief
from aria_slam_tpu_torch.ops import fast as tfast
from aria_slam_tpu_torch.ops import match as tmatch
from aria_slam_tpu_torch.ops import orient as torient
from aria_slam_tpu_torch.ops import pyramid as tpyramid
from aria_slam_tpu_torch.utils import profiling as tprofiling

from torch_parity_util import rendered_frames

RNG = np.random.default_rng(13)


def _keypoints(n, h, w):
    """Keypoints over the whole image, the edges included (the gathers
    clamp their centres), with random angles."""
    xy = np.stack([RNG.uniform(-3, w + 3, n), RNG.uniform(-3, h + 3, n)], -1)
    return xy.astype(np.float32), RNG.uniform(-np.pi, np.pi, n).astype(np.float32)


def case_describe():
    """Bits exact: each is the sign of a difference of two bf16 pixels."""
    img = jpyramid.box_blur(jnp.asarray(rendered_frames(1)[0]))
    xy, ang = _keypoints(300, *img.shape)
    pattern = tbrief.brief_pattern()
    want = jbrief.describe(img, jnp.asarray(xy), jnp.asarray(ang), pattern)
    got = tbrief.describe(torch.from_numpy(np.asarray(img)), torch.from_numpy(xy),
                          torch.from_numpy(ang), pattern)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def case_describe_from_patches():
    """Bits exact, leading batch axes kept."""
    patches = RNG.uniform(0, 255, (2, 64, tbrief.PATCH_S ** 2)).astype(np.float32)
    ang = RNG.uniform(-4, 4, (2, 64)).astype(np.float32)
    pattern = tbrief.brief_pattern()
    want = jbrief.describe_from_patches(jnp.asarray(patches), jnp.asarray(ang), pattern)
    got = tbrief.describe_from_patches(torch.from_numpy(patches), torch.from_numpy(ang), pattern)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def case_unpack_bits():
    """Exact: the JAX package's packed uint32 words unpack to its bits,
    and the port's own pack_bits round-trips."""
    bits = RNG.integers(0, 2, (50, 256)).astype(np.int8)
    packed = np.asarray(jbrief.pack_bits(jnp.asarray(bits)))
    want = np.asarray(jbrief.unpack_bits(jnp.asarray(packed)))
    got = tbrief.unpack_bits(torch.from_numpy(packed.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, bits)
    np.testing.assert_array_equal(
        tbrief.unpack_bits(tbrief.pack_bits(torch.from_numpy(bits))).numpy(), bits)


def case_orientations():
    """Angles within 1e-5 rad: float32 moment sums of ~700 terms in
    another order."""
    img = rendered_frames(1)[0]
    xy, _ = _keypoints(300, *img.shape)
    want = jorient.orientations(jnp.asarray(img), jnp.asarray(xy))
    got = torient.orientations(torch.from_numpy(img), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def case_orientations_from_patches():
    """The central window of larger patches; within 1e-5 rad."""
    patches = np.round(RNG.uniform(0, 255, (64, 39, 39))).astype(np.float32)
    want = jorient.orientations_from_patches(jnp.asarray(patches))
    got = torient.orientations_from_patches(torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def case_detect_level():
    """ORB's border (31 px) and a top-k above the corner count: the same
    corners, valid flags and order of positions; Harris responses within
    1e-3 relative (tests_tpu/parity.py's gate: the reference's map sums
    its 7x7 boxes in another order); with a top-k below the count, the
    kept sets overlap at IoU >= 0.99 (near-equal responses may swap at
    the cut)."""
    img = rendered_frames(1)[0]
    for top_k in (4000, 300):
        jxy, jr, jv = (np.asarray(a) for a in jfast.detect_level(jnp.asarray(img), 20.0, top_k,
                                                                 31))
        txy, tr, tv = (a.numpy() for a in tfast.detect_level(torch.from_numpy(img), 20.0,
                                                             top_k, 31))
        assert txy.shape == (top_k, 2) and tv.dtype == bool
        js = {tuple(p) for p in jxy[jv]}
        ts = {tuple(p) for p in txy[tv]}
        if top_k > jv.sum():
            assert js == ts and tv.sum() == jv.sum() < top_k
            order = np.lexsort(txy[tv].T)
            jorder = np.lexsort(jxy[jv].T)
            np.testing.assert_array_equal(txy[tv][order], jxy[jv][jorder])
            np.testing.assert_allclose(tr[tv][order], jr[jv][jorder], rtol=1e-3)
        else:
            assert tv.all() and jv.all()
            assert len(js & ts) / len(js | ts) >= 0.99


def case_box_blur():
    """Within 1e-4 grey levels: float32 taps times 1/5 in window order,
    the reference's a convolution."""
    img = RNG.uniform(0, 255, (37, 53)).astype(np.float32)
    for size in (3, 5):
        want = jpyramid.box_blur(jnp.asarray(img), size)
        got = tpyramid.box_blur(torch.from_numpy(img), size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def case_hamming_matrix():
    """Exact integer distances, the invalid columns' sentinel included."""
    q = RNG.integers(0, 2, (70, 256)).astype(np.int8)
    t = RNG.integers(0, 2, (90, 256)).astype(np.int8)
    valid = RNG.uniform(size=90) < 0.8
    for v in (None, valid):
        want = jmatch.hamming_matrix(jnp.asarray(q), jnp.asarray(t),
                                     None if v is None else jnp.asarray(v))
        got = tmatch.hamming_matrix(torch.from_numpy(q), torch.from_numpy(t),
                                    None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def case_top2_min():
    """Exact along either axis: ties to the lowest index, every entry past
    the clip reported as the sentinel."""
    dist = RNG.integers(0, 12, (40, 33)).astype(np.int32)  # many ties
    dist[3] = 1 << 20
    dist[5, 1:] = 1 << 20
    for axis in (-1, 0):
        want = jmatch.top2_min(jnp.asarray(dist), axis)
        got = tmatch.top2_min(torch.from_numpy(dist), axis)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def case_init_params():
    """The same variable tree and shapes; kernels within 1e-7 (the JAX
    init's fused multiply-add in its uniform draw, PR 11: 6e-8 on about
    1 % of the entries), every other variable exact; the model holds
    the kernels it returns."""
    cfg = DetectorConfig(input_size=64, width_mult=0.25, depth_mult=0.33, num_classes=2)
    _, want = jyolo.init_params(cfg, jax.random.key(7))
    model, got = tyolo.init_params(cfg, 7)
    _, got_raw = tyolo.init_params(cfg, np.asarray(jax.random.key_data(jax.random.key(7))))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {f"{prefix}{k}": np.asarray(v)})
        return out

    fw, fg, fr = flat(dict(want)), flat(got), flat(got_raw)
    assert sorted(fw) == sorted(fg) == sorted(fr)
    for k in fw:
        assert fg[k].shape == fw[k].shape, k
        np.testing.assert_array_equal(fg[k], fr[k])
        if k.endswith("/kernel"):
            np.testing.assert_allclose(fg[k], fw[k], rtol=0, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    state = model.state_dict()
    name = next(n for n in state if n.endswith(".kernel"))
    assert state[name].dtype == torch.float32
    np.testing.assert_array_equal(
        state[name].numpy().transpose(2, 3, 1, 0),
        fg["params/" + name.replace(".", "/")])


def case_native_available():
    """Both libraries build and load here."""
    assert jnative.available() is True
    assert tnative.available() is True


def case_device_trace():
    """Each writes a trace of the region under its directory (the port's
    torch.profiler JSON, the JAX package's xplane)."""
    def files(d):
        return [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]

    with tempfile.TemporaryDirectory() as tmp:
        with jprofiling.device_trace(os.path.join(tmp, "jax")):
            jnp.ones(8).sum().block_until_ready()
        with tprofiling.device_trace(os.path.join(tmp, "torch"), device="cpu"):
            torch.ones(8).sum()
        for d in ("jax", "torch"):
            written = files(os.path.join(tmp, d))
            assert written and all(os.path.getsize(f) > 0 for f in written), (d, written)
        assert any(f.endswith(".pt.trace.json") for f in files(os.path.join(tmp, "torch")))


CASES = {
    "brief.describe": case_describe,
    "brief.describe_from_patches": case_describe_from_patches,
    "brief.unpack_bits": case_unpack_bits,
    "orient.orientations": case_orientations,
    "orient.orientations_from_patches": case_orientations_from_patches,
    "fast.detect_level": case_detect_level,
    "pyramid.box_blur": case_box_blur,
    "match.hamming_matrix": case_hamming_matrix,
    "match.top2_min": case_top2_min,
    "yolo.init_params": case_init_params,
    "native.available": case_native_available,
    "profiling.device_trace": case_device_trace,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_function_matches_jax(name):
    CASES[name]()
