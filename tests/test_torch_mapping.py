"""Mapping and the chunked evaluator's state file in the port (on the
CPU) against the JAX package: triangulation, the mapper's gates and
filters, the map insert (compacted, overflowing, with no host read),
PLY / PCD export byte for byte, triangulate_and_filter on a JAX chunked
run's own inputs, a chunked run with mapping on through both packages,
and snapshot / restore: the port's own files, a JAX file, and each
older layout the JAX package's restore accepts.

One JAX ChunkedSlam pays the compile once (module fixture)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.eval.chunked import ChunkedSlam as JaxChunkedSlam
from aria_slam_tpu.mapping import export as jexport
from aria_slam_tpu.mapping import mapper as jmapper
from aria_slam_tpu.ops import triangulate as jtri
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.core.types import KeyframeDB, MapState, PoseGraph
from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
from aria_slam_tpu_torch.mapping import export as texport
from aria_slam_tpu_torch.mapping import mapper as tmapper
from aria_slam_tpu_torch.ops import triangulate as ttri

from torch_parity_util import JaxChunkChainSampler, chunk_scene, small_config, to_np

K_NP = np.array([[458.0, 0, 376.0], [0, 457.0, 240.0], [0, 0, 1.0]], np.float32)
MCFG_J = jcfg.MapperConfig(max_points=4096)
MCFG_T = tcfg.MapperConfig(max_points=4096)

# The chunked run: tests/test_torch_chunked.py's scene and seed (both
# packages take the same RANSAC branch at every pair), mapping on into a
# map of 300 points that the third chunk overflows, a 16-slot keyframe DB
# (loop closure off; the JAX package keeps a DB all the same, so its file
# has one), the IMU estimator fed.
CHUNK = 5
NCHUNKS = 3
SEED = 2
SNAP_AFTER = 2
MAX_POINTS = 300


def _cfg(module, **kw):
    return small_config(module, enable_mapping=True, vo_backbone_scale=True,
                        mapper=module.MapperConfig(max_points=MAX_POINTS),
                        loop=module.LoopClosureConfig(max_keyframes=16), **kw)


JCFG = _cfg(jcfg)
TCFG = _cfg(tcfg)

# DLT tolerance (ROADMAP.md queue 3: the DLT is the 8-point solve's
# eigenvector problem): points within 1e-3 relative; a keep flag may
# differ only for a point this close to one of the gates
DLT_RTOL = 1e-3
GATE_MARGIN = {"depth_rel": 1e-3, "parallax_deg": 0.01, "reproj_px": 0.01}


def _t(x):
    return torch.from_numpy(np.array(x))


def two_view_scene(seed=0, n=128, baseline=0.5):
    """tests/test_mapper.py's scene: points in front of two cameras 0.5 m apart."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -3, 4], [4, 3, 20], size=(n, 3)).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)  # camera-from-world
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [-baseline, 0, 0]

    def project(T):
        Xc = pts @ T[:3, :3].T + T[:3, 3]
        uv = Xc[:, :2] / Xc[:, 2:3]
        return (uv * [K_NP[0, 0], K_NP[1, 1]] + [K_NP[0, 2], K_NP[1, 2]]).astype(np.float32)

    return pts, T1, T2, project(T1), project(T2)


def _assert_map_equal(jm, tm):
    j = to_np(jm)
    for f in MapState.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(j, f), getattr(tm, f).numpy(), err_msg=f)


def _gate_distance(K, T1, T2, uv1, uv2, X, cfg):
    """For points X (N, 3): how far each lies from the nearest gate
    threshold, in the units of GATE_MARGIN (True where within it)."""
    def cam(T):
        return X @ T[:3, :3].T + T[:3, 3]

    Xc1, Xc2 = cam(T1), cam(T2)
    near = np.zeros(len(X), bool)
    for z in (Xc1[:, 2], Xc2[:, 2]):
        for g in (cfg.min_depth, cfg.max_depth):
            near |= np.abs(z - g) <= GATE_MARGIN["depth_rel"] * g
    C1 = -T1[:3, :3].T @ T1[:3, 3]
    C2 = -T2[:3, :3].T @ T2[:3, 3]
    r1 = (X - C1) / np.linalg.norm(X - C1, axis=1, keepdims=True)
    r2 = (X - C2) / np.linalg.norm(X - C2, axis=1, keepdims=True)
    par = np.degrees(np.arccos(np.clip(np.abs((r1 * r2).sum(1)), 0, 1)))
    near |= np.abs(par - cfg.min_parallax_deg) <= GATE_MARGIN["parallax_deg"]
    for Xc, uv in ((Xc1, uv1), (Xc2, uv2)):
        z = np.maximum(Xc[:, 2], 1e-9)
        err = np.hypot(K[0, 0] * Xc[:, 0] / z + K[0, 2] - uv[:, 0],
                       K[1, 1] * Xc[:, 1] / z + K[1, 2] - uv[:, 1])
        near |= np.abs(err - cfg.max_reproj_error_px) <= GATE_MARGIN["reproj_px"]
    return near


# ------------------------------------------------------- triangulation
def test_dlt_matches_jax():
    """triangulate_calibrated against the JAX function (the JAX test's
    OpenCV oracle): within 1e-3 relative, and within 2e-2 m of the
    scene; the pixel-space DLT within 0.5 m; projection matrices equal;
    a stack of three pairs in one call equals pair by pair."""
    pts, T1, T2, uv1, uv2 = two_view_scene()
    K = _t(K_NP)
    np.testing.assert_allclose(ttri.projection_matrix(K, _t(T2)).numpy(),
                               np.asarray(jtri.projection_matrix(jnp.asarray(K_NP),
                                                                 jnp.asarray(T2))), rtol=1e-6)
    ours = ttri.triangulate_calibrated(K, _t(T1), _t(T2), _t(uv1), _t(uv2)).numpy()
    ref = np.asarray(jtri.triangulate_calibrated(*(jnp.asarray(a) for a in (K_NP, T1, T2, uv1,
                                                                            uv2))))
    np.testing.assert_allclose(ours, ref, rtol=DLT_RTOL, atol=1e-4)
    np.testing.assert_allclose(ours, pts, atol=2e-2)
    P1, P2 = ttri.projection_matrix(K, _t(T1)), ttri.projection_matrix(K, _t(T2))
    np.testing.assert_allclose(ttri.triangulate_dlt(P1, P2, _t(uv1), _t(uv2)).numpy(), pts,
                               atol=0.5)
    scenes = [two_view_scene(s, baseline=b) for s, b in ((1, 0.3), (2, 0.5), (3, 0.8))]
    stack = [np.stack([s[i] for s in scenes]) for i in range(1, 5)]
    batched = ttri.triangulate_calibrated(K, *(_t(a) for a in stack)).numpy()
    for p, s in enumerate(scenes):
        one = ttri.triangulate_calibrated(K, *(_t(a) for a in s[1:])).numpy()
        np.testing.assert_allclose(batched[p], one, rtol=1e-5, atol=1e-5)


def _add(pts_args, valid=None, module="torch"):
    pts, T1, T2, uv1, uv2 = pts_args
    valid = np.ones(len(uv1), bool) if valid is None else valid
    if module == "jax":
        m = jmapper.init_map(MCFG_J)
        return jmapper.add_from_matches(m, *(jnp.asarray(a) for a in (K_NP, T1, T2, uv1, uv2,
                                                                      valid)), None, MCFG_J)
    m = tmapper.init_map(MCFG_T, "cpu")
    return tmapper.add_from_matches(m, *(_t(a) for a in (K_NP, T1, T2, uv1, uv2, valid)), None,
                                    MCFG_T)


def test_filters_accept_good_points():
    """Most of the clean scene survives, each point on its scene point; the
    map equals the JAX one (keep flags and order exactly, points within
    the DLT tolerance, the reprojection errors behind the quality within
    1e-3 px)."""
    scene = two_view_scene()
    tm, jm = _add(scene), to_np(_add(scene, module="jax"))
    assert int(tm.count) > 100 and int(tm.count) == int(jm.count)
    np.testing.assert_array_equal(tm.valid.numpy(), jm.valid)
    live = tm.points.numpy()[tm.valid.numpy()]
    assert np.linalg.norm(live[:, None] - scene[0][None], axis=-1).min(1).max() < 0.1
    np.testing.assert_allclose(tm.points.numpy(), jm.points, rtol=DLT_RTOL, atol=1e-4)
    # quality = 1 / (e1 + e2 + 0.1): the two reprojection errors' sum within 1e-3 px
    np.testing.assert_allclose(1 / tm.quality.numpy()[jm.valid], 1 / jm.quality[jm.valid],
                               atol=1e-3)


def test_filters_reject_outliers():
    """Corrupted correspondences fail the reprojection gate, as in JAX."""
    pts, T1, T2, uv1, uv2 = two_view_scene()
    rng = np.random.default_rng(1)
    bad = rng.choice(len(uv1), 40, replace=False)
    uv2_bad = uv2.copy()
    uv2_bad[bad] += rng.uniform(20, 80, size=(40, 2)).astype(np.float32)
    scene = (pts, T1, T2, uv1, uv2_bad)
    tm, jm = _add(scene), to_np(_add(scene, module="jax"))
    assert int(tm.count) <= len(uv1) - 35
    np.testing.assert_array_equal(tm.valid.numpy(), jm.valid)


def test_too_few_matches_adds_nothing():
    """Parity: triangulate() needs >= 8 matches (Mapper.cpp:13)."""
    valid = np.zeros(128, bool)
    valid[:5] = True
    assert int(_add(two_view_scene(), valid).count) == 0
    valid[:8] = True
    assert int(_add(two_view_scene(), valid).count) == 8


def test_statistical_outlier_filter_distance_and_box_match_jax():
    """filter_outliers, filter_by_distance and bounding_box against JAX on
    500 points with 5 gross outliers: masks exactly, the box within 1e-6;
    the JAX map carried over by convert.map_state_from_numpy filters the
    same."""
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 1.0, size=(500, 3)).astype(np.float32)
    pts[:5] *= 100.0
    args = (pts, np.full((500, 3), 0.5, np.float32), np.ones(500, np.float32), np.ones(500, bool))
    jm = jmapper.insert_points(jmapper.init_map(MCFG_J), *(jnp.asarray(a) for a in args))
    tm = tmapper.insert_points(tmapper.init_map(MCFG_T, "cpu"), *(_t(a) for a in args))
    _assert_map_equal(jm, tm)
    t2, j2 = tmapper.filter_outliers(tm, sigma=3.0), jmapper.filter_outliers(jm, sigma=3.0)
    np.testing.assert_array_equal(t2.valid.numpy(), np.asarray(j2.valid))
    assert t2.valid.sum() >= 490 and not t2.valid[:5].any()
    origin = np.array([0.5, 0.0, -0.2], np.float32)
    np.testing.assert_array_equal(
        tmapper.filter_by_distance(tm, 2.0, _t(origin)).valid.numpy(),
        np.asarray(jmapper.filter_by_distance(jm, 2.0, jnp.asarray(origin)).valid))
    for a, b in zip(tmapper.bounding_box(t2), jmapper.bounding_box(j2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # the same filters on the JAX map carried over (convert.map_state_from_numpy)
    carried = convert.map_state_from_numpy(to_np(jm), "cpu")
    _assert_map_equal(jm, carried)
    np.testing.assert_array_equal(tmapper.filter_outliers(carried, sigma=3.0).valid.numpy(),
                                  np.asarray(j2.valid))


def test_insert_overflows_exactly_without_host_read():
    """insert_points into a 64-point map, three times (the second fills it
    part way, the third overflows with points kept and dropped mixed):
    every field exactly as the JAX insert's after every call. The same
    calls on meta tensors (which have no data: any read on the host,
    .item(), nonzero or a bool() raises) go through, and the slots it
    writes stay in [0, P]."""
    small_j, small_t = jcfg.MapperConfig(max_points=64), tcfg.MapperConfig(max_points=64)
    jm, tm = jmapper.init_map(small_j), tmapper.init_map(small_t, "cpu")
    rng = np.random.default_rng(3)
    for n, p_keep in ((20, 1.0), (50, 0.6), (100, 0.5)):
        args = (rng.normal(size=(n, 3)).astype(np.float32),
                rng.random((n, 3)).astype(np.float32), rng.random(n).astype(np.float32),
                rng.random(n) < p_keep)
        jm = jmapper.insert_points(jm, *(jnp.asarray(a) for a in args))
        tm = tmapper.insert_points(tm, *(_t(a) for a in args))
        _assert_map_equal(jm, tm)
    assert int(tm.count) == 64 and int(tm.valid.sum()) == 64
    meta = tmapper.init_map(small_t, "meta")
    for _ in range(2):
        meta = tmapper.insert_points(meta, *(torch.zeros(s, device="meta")
                                             for s in ((100, 3), (100, 3), (100,))),
                                     torch.ones(100, dtype=torch.bool, device="meta"))
    assert meta.points.shape == (64, 3) and meta.count.shape == ()


def test_ply_pcd_export_byte_for_byte(tmp_path, monkeypatch):
    """export_ply / export_pcd write the files the JAX package's numpy
    writer writes (its C writer switched off), byte for byte, colours
    clipped and packed; an empty map too."""
    from aria_slam_tpu import native

    monkeypatch.setattr(native, "write_ply", lambda *a: None)
    monkeypatch.setattr(native, "write_pcd", lambda *a: None)
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 3, (50, 3)).astype(np.float32)
    cols = rng.uniform(-0.2, 1.2, (50, 3)).astype(np.float32)
    keep = rng.random(50) > 0.3
    args = (pts, cols, np.ones(50, np.float32), keep)
    jm = jmapper.insert_points(jmapper.init_map(MCFG_J), *(jnp.asarray(a) for a in args))
    tm = tmapper.insert_points(tmapper.init_map(MCFG_T, "cpu"), *(_t(a) for a in args))
    for name, m_j, m_t in (("full", jm, tm), ("empty", jmapper.init_map(MCFG_J),
                                              tmapper.init_map(MCFG_T, "cpu"))):
        for ext, jw, tw in (("ply", jexport.export_ply, texport.export_ply),
                            ("pcd", jexport.export_pcd, texport.export_pcd)):
            pj, pt = tmp_path / f"{name}_j.{ext}", tmp_path / f"{name}_t.{ext}"
            assert jw(m_j, str(pj)) == tw(m_t, str(pt)) == int(m_t.count)
            assert pj.read_bytes() == pt.read_bytes(), (name, ext)
    assert "element vertex 0" in (tmp_path / "empty_t.ply").read_text()


# ------------------------------------------------------- the chunked run
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The scene through both ChunkedSlams with mapping on, the port drawing
    the JAX run's samples; the JAX run's mapping inputs recorded at every
    state commit; a JAX snapshot after SNAP_AFTER chunks (and its key);
    a port snapshot at the same point; then finalize."""
    frames, ts, gt, imu, Rg, okg = chunk_scene(NCHUNKS * CHUNK + 1)
    js = JaxChunkedSlam(JCFG, chunk=CHUNK, seed=SEED)
    tslam = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu",
                        sampler=JaxChunkChainSampler(jax.random.key(SEED), js.lag))
    commits = []
    state_update = js._state_update

    def recorded(graph, db, mstate, a):
        commits.append({k: np.array(a[k]) for k in ("T1", "T2", "uv1", "uv2", "lv",
                                                    "frames_lag")})
        return state_update(graph, db, mstate, a)

    js._state_update = recorded
    d = tmp_path_factory.mktemp("snap")
    res = dict(frames=frames, ts=ts, gt=gt, imu=imu, Rg=Rg, okg=okg, lag=js.lag, commits=commits,
               jsnap=str(d / "jax.npz"), tsnap=str(d / "port.npz"), counts=[])
    res["chunks"] = [(frames[s:s + CHUNK + 1], ts[s:s + CHUNK + 1], Rg[s:s + CHUNK],
                      okg[s:s + CHUNK], imu) for s in range(0, NCHUNKS * CHUNK, CHUNK)]
    for k, args in enumerate(res["chunks"]):
        if k == SNAP_AFTER:
            js.snapshot(res["jsnap"])
            tslam.snapshot(res["tsnap"])
            res["key_after"] = js._key
            res["maps_at_snap"] = (to_np(js.map_state), tslam.map_state.map(torch.clone))
        js.process_chunk(*args)
        tslam.process_chunk(*args)
        res["counts"].append((int(js.map_state.count), int(tslam.map_state.count)))
    res["online"] = (np.stack([T for _, T in js.trajectory]),
                     np.stack([T for _, T in tslam.trajectory]))
    res["maps"] = (to_np(js.map_state), tslam.map_state)
    js.finalize()
    tslam.finalize()
    res["final_maps"] = (to_np(js.get_map()), tslam.get_map())
    res["final"] = (np.stack([T for _, T in js.trajectory]),
                    np.stack([T for _, T in tslam.trajectory]))
    return res


def test_triangulate_and_filter_on_chunk_inputs(run):
    """The port's triangulate_and_filter on the JAX run's own state-commit
    inputs (lag pairs, camera-from-world ends, uint8 frames), batched over
    the chunk's pairs and pair by pair, against the JAX function pair by
    pair: points within 1e-3 relative, colours and keep flags exactly,
    except keep flags of points within GATE_MARGIN of a gate (counted and
    printed). Batched and pair by pair agree."""
    K = _t(np.asarray(TCFG.camera.K, np.float32))
    jfn = jax.jit(lambda *a: jmapper.triangulate_and_filter(jnp.asarray(TCFG.camera.K), *a,
                                                            JCFG.mapper))
    n_near = n_flip = n_kept = 0
    for a in run["commits"]:
        args = [_t(a[k]) for k in ("T1", "T2", "uv1", "uv2", "lv", "frames_lag")]
        bX, bC, bQ, bK = tmapper.triangulate_and_filter(K, *args, TCFG.mapper)
        for p in range(len(a["lv"])):
            one = [x[p] for x in args]
            X, C, Q, keep = (x.numpy() for x in tmapper.triangulate_and_filter(K, *one,
                                                                                TCFG.mapper))
            jX, jC, jQ, jkeep = (np.asarray(x) for x in jfn(*(jnp.asarray(a[k][p]) for k in (
                "T1", "T2", "uv1", "uv2", "lv", "frames_lag"))))
            np.testing.assert_allclose(bX[p].numpy(), X, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(bK[p].numpy(), keep)
            np.testing.assert_array_equal(bC[p].numpy(), C)
            np.testing.assert_array_equal(C, jC)
            both = keep & jkeep
            np.testing.assert_allclose(X[both], jX[both], rtol=DLT_RTOL, atol=1e-4)
            np.testing.assert_allclose(1 / Q[both], 1 / jQ[both], atol=1e-3)
            flips = keep != jkeep
            near = _gate_distance(np.asarray(TCFG.camera.K), a["T1"][p], a["T2"][p],
                                  a["uv1"][p], a["uv2"][p], jX, TCFG.mapper)
            assert not (flips & ~near).any(), np.flatnonzero(flips & ~near)
            n_flip += int(flips.sum())
            n_near += int((near & a["lv"][p]).sum())
            n_kept += int(jkeep.sum())
    print(f"\n{n_kept} points kept by JAX over {len(run['commits'])} chunks; {n_near} valid "
          f"matches within the gate margins, {n_flip} keep flags differ")
    assert n_kept > 300 and n_flip <= max(3, n_kept // 100)


def test_chunked_mapping_matches_jax(run):
    """The chunked run with mapping on through both packages. The map's
    count after every chunk is equal (the third overflows the 300-point
    map), and so every slot holds the same match in both maps: colours
    exactly equal. The first chunk's points, triangulated from poses
    that agree to 5e-6 m, at the DLT tolerance. After that chunk BA
    leaves the two trajectories up to 1.3 % of the path apart
    (tests/test_torch_chunked.py holds them to 2 %), and the points
    follow: within 10 % relative, half of them within 2 % (measured 5.7 %
    and 0.9 %). get_map after finalize keeps the same points but 3."""
    counts = run["counts"]
    assert counts[-1] == (MAX_POINTS, MAX_POINTS), counts
    assert all(cj == ct for cj, ct in counts), counts
    (jm, tm), (jfin, tfin) = run["maps"], run["final_maps"]
    np.testing.assert_array_equal(tm.valid.numpy(), jm.valid)
    np.testing.assert_array_equal(tm.colors.numpy(), jm.colors)
    n1 = counts[0][0]
    np.testing.assert_allclose(tm.points.numpy()[:n1], jm.points[:n1], rtol=DLT_RTOL, atol=1e-4)
    pj, pt = jm.points[jm.valid], tm.points.numpy()[jm.valid]
    rel = np.linalg.norm(pt - pj, axis=1) / np.linalg.norm(pj, axis=1)
    print(f"\nmap points, port against JAX slot by slot: relative distance median "
          f"{np.median(rel):.2e}, max {rel.max():.2e}")
    assert rel.max() < 0.1 and np.median(rel) < 0.02
    assert (jfin.valid != tfin.valid.numpy()).sum() <= 3
    assert tfin.valid.sum() > 0.9 * MAX_POINTS
    tj, tt = run["online"]
    path = np.linalg.norm(np.diff(run["gt"], axis=0), axis=1).sum()
    assert np.abs(tj[:CHUNK + 1, :3, 3] - tt[:CHUNK + 1, :3, 3]).max() < 5e-6
    assert np.linalg.norm(tj[:, :3, 3] - tt[:, :3, 3], axis=1).max() < 0.02 * path


def test_port_snapshot_continues_identically(run, tmp_path):
    """A port ChunkedSlam on its own seeded generator: snapshot after two
    chunks, restore into a fresh one (another seed: the generator state
    comes from the file), run the third chunk in both; trajectories, map,
    pose graph and the scale state come out identical."""
    a = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu", seed=3)
    for args in run["chunks"][:SNAP_AFTER]:
        a.process_chunk(*args)
    path = str(tmp_path / "mid.npz")
    a.snapshot(path)
    b = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu", seed=99)
    b.restore(path)
    for s in (a, b):
        s.process_chunk(*run["chunks"][SNAP_AFTER])
    for name in ("map_state", "graph"):
        for f in dataclasses.fields(getattr(a, name)):
            assert torch.equal(getattr(getattr(a, name), f.name),
                               getattr(getattr(b, name), f.name)), (name, f.name)
    assert [t for t, _ in a.trajectory] == [t for t, _ in b.trajectory]
    np.testing.assert_array_equal(np.stack([T for _, T in a.trajectory]),
                                  np.stack([T for _, T in b.trajectory]))
    assert (a._scale, a._imu_corr, a._vis_local, a.frame_count) == (
        b._scale, b._imu_corr, b._vis_local, b.frame_count)
    assert a._scale_est._hist == b._scale_est._hist
    with np.load(path) as f:
        assert "torch_rng" in f and "rng" not in f and "db.desc" not in f
        assert f["counters"].dtype == np.int64 and f["scales"].dtype == np.float64


def test_snapshot_keys_match_jax(run):
    """The port's file holds the JAX file's keys with the same shapes and
    dtypes, except the JAX key `rng` (the port's is `torch_rng`) and the
    keyframe DB, which the port holds only with loop closure on."""
    with np.load(run["jsnap"]) as j, np.load(run["tsnap"]) as t:
        jkeys = {k for k in j.files if k != "rng" and not k.startswith("db.")}
        assert jkeys == set(t.files) - {"torch_rng"}
        for k in jkeys:
            assert (j[k].shape, j[k].dtype) == (t[k].shape, t[k].dtype), k


def test_jax_snapshot_with_map_restores_and_continues(run):
    """The JAX file after two chunks restores into the port (restore, and
    convert.chunked_state_from_numpy, the same reader): the map, graph and
    carried state field for field; then the third chunk on the JAX key
    chain from there lands the JAX run's map count (within one point)
    and poses (within 2 % of the path, the tolerance of
    tests/test_torch_chunked.py)."""
    t = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu",
                    sampler=JaxChunkChainSampler(run["key_after"], run["lag"]))
    t.restore(run["jsnap"])
    jmap, _ = run["maps_at_snap"]
    _assert_map_equal(jmap, t.map_state)
    with np.load(run["jsnap"]) as state:
        np.testing.assert_array_equal(t.graph.node_pose.numpy(), state["graph.node_pose"])
        assert (t.frame_count, t._db_head) == tuple(state["counters"][[0, 2]])
        c = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu")
        convert.chunked_state_from_numpy(c, state)
    _assert_map_equal(jmap, c.map_state)
    t.process_chunk(*run["chunks"][SNAP_AFTER])
    assert abs(int(t.map_state.count) - run["counts"][SNAP_AFTER][0]) <= 1
    got = np.stack([T for _, T in t.trajectory])
    path = np.linalg.norm(np.diff(run["gt"], axis=0), axis=1).sum()
    assert got.shape == run["online"][0].shape
    assert np.linalg.norm(got[:, :3, 3] - run["online"][0][:, :3, 3], axis=1).max() < 0.02 * path


def _older(state: dict, kind: str) -> dict:
    """The JAX file's arrays rewritten into one older layout."""
    s = dict(state)
    if kind == "two_counters":
        s["counters"] = s["counters"][:2]
    elif kind == "three_scales":
        s["scales"] = s["scales"][:3]
    elif kind == "no_est_hist":
        del s["est_hist"]
    elif kind == "no_db_covis":
        del s["db.covis"]
    elif kind == "positional":
        for name, cls in (("graph", PoseGraph), ("db", KeyframeDB), ("map_state", MapState)):
            for i, f in enumerate(cls.__dataclass_fields__):
                s[f"{name}_{i}"] = s.pop(f"{name}.{f}")
    return s


@pytest.mark.parametrize("kind", ["two_counters", "three_scales", "no_est_hist", "no_db_covis",
                                  "positional"])
def test_older_layouts_restore(run, tmp_path, kind):
    """Each older layout the JAX package's restore accepts restores into
    the port (loop closure on, so the DB is read): the missing counter
    gives a head of 0, missing scales 1.0, a missing est_hist an empty
    history, a missing db.covis the fresh matrix, and the positional
    layout every field. A positional file whose state has since gained
    fields raises ValueError, as in the JAX package."""
    with np.load(run["jsnap"]) as f:
        state = dict(f)
    path = str(tmp_path / f"{kind}.npz")
    np.savez(path, **_older(state, kind))
    t = ChunkedSlam(dataclasses.replace(TCFG, enable_loop_closure=True), chunk=CHUNK,
                    device="cpu")
    fresh_covis = t.db.covis.clone()
    t.restore(path)
    assert t._db_head == (0 if kind == "two_counters" else int(state["counters"][2]))
    want = state["scales"] if kind != "three_scales" else [*state["scales"][:3], 1.0, 1.0]
    assert [t._scale, t._imu_corr, t._vis_corr, t._ba_corr, t._vis_local] == list(want)
    assert t._scale_est._hist == ([] if kind == "no_est_hist" else
                                  [tuple(h) for h in state["est_hist"]])
    for name, cls in (("graph", PoseGraph), ("db", KeyframeDB), ("map_state", MapState)):
        for f in cls.__dataclass_fields__:
            got = getattr(getattr(t, name), f).numpy()
            if kind == "no_db_covis" and (name, f) == ("db", "covis"):
                np.testing.assert_array_equal(got, fresh_covis.numpy())
            else:
                np.testing.assert_array_equal(got, state[f"{name}.{f}"], err_msg=f"{name}.{f}")
    if kind == "positional":
        short = _older(state, kind)
        del short["db_6"], short["db_7"], short["db_8"]
        short.update(db_6=state["db.size"], db_7=state["db.head"])  # a pre-covis DB
        np.savez(path, **short)
        with pytest.raises(ValueError, match="positional layout"):
            t.restore(path)
