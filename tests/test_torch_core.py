"""Port skeleton: config, types, Lie algebra and small linear algebra
against the JAX package, plus the port's guards (no JAX import, no
silent CPU fallback, unported features raise)."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.core import lie as jlie
from aria_slam_tpu.ops import linalg as jlinalg
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.core import lie as tlie
from aria_slam_tpu_torch.ops import linalg as tlinalg

from torch_parity_util import TORCH_SMALL_CFG

REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=tol, rtol=0)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("name", [
    "CameraConfig", "OrbConfig", "MatcherConfig", "RansacConfig", "EkfConfig",
    "LoopClosureConfig", "MapperConfig", "DetectorConfig", "PoseGraphConfig",
    "ChunkBaConfig", "PipelineConfig",
])
def test_config_dataclasses_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert jf == tf
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    assert t.__dataclass_params__.frozen


def test_config_from_dict_and_yaml_round_trip(tmp_path):
    d = jcfg.PipelineConfig(orb=jcfg.OrbConfig(num_features=500),
                            vo_scale_mode="propagate").to_dict()
    t = tcfg.PipelineConfig.from_dict(d)
    assert t.to_dict() == d
    assert t.orb.num_features == 500 and t.vo_scale_mode == "propagate"
    np.testing.assert_array_equal(t.camera.K, jcfg.CameraConfig().K)
    y = tmp_path / "cfg.yaml"
    y.write_text("orb: {num_features: 384, num_levels: 3}\nransac: {num_hypotheses: 128}\n"
                 "enable_mapping: false\n")
    assert tcfg.PipelineConfig.from_yaml(str(y)).to_dict() == \
        jcfg.PipelineConfig.from_yaml(str(y)).to_dict()


def test_empty_features_match():
    from aria_slam_tpu.core.types import make_empty_features as jmake
    from aria_slam_tpu_torch.core.types import make_empty_features as tmake

    j, t = jmake(16), tmake(16, device="cpu")
    for f in dataclasses.fields(t):
        a, b = np.asarray(getattr(j, f.name)), getattr(t, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- lie
@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 2.5])
def test_lie_matches_reference(scale):
    rng = np.random.default_rng(int(scale * 1e7) % 1000)
    phi = (rng.normal(size=(64, 3)) * scale).astype(np.float32)
    xi = (rng.normal(size=(64, 6)) * scale).astype(np.float32)
    _close(jlie.skew(jnp.asarray(phi)), tlie.skew(_t(phi)), 1e-7)
    R = jlie.so3_exp(jnp.asarray(phi))
    _close(R, tlie.so3_exp(_t(phi)), 1e-5)
    _close(jlie.so3_log(R), tlie.so3_log(_t(R)), 1e-5)
    T = jlie.se3_exp(jnp.asarray(xi))
    _close(T, tlie.se3_exp(_t(xi)), 1e-5)
    _close(jlie.se3_log(T), tlie.se3_log(_t(T)), 1e-5)
    _close(jlie.se3_inverse(T), tlie.se3_inverse(_t(T)), 1e-5)
    _close(jlie.se3_matrix(R, jnp.asarray(xi[:, :3])),
           tlie.se3_matrix(_t(R), _t(xi[:, :3])), 1e-7)


# ----------------------------------------------------------------- linalg
def _spd(rng, n, batch=32):
    a = rng.normal(size=(batch, n, n)).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [3, 6, 9])
def test_cholesky_solvers_match(n):
    rng = np.random.default_rng(n)
    M = _spd(rng, n)
    b = rng.normal(size=(32, n)).astype(np.float32)
    Mj = jnp.asarray(M)
    _close(jlinalg.cholesky_unrolled(Mj), tlinalg.cholesky_unrolled(_t(M)), 1e-5)
    _close(jlinalg.cholesky_solve(Mj, jnp.asarray(b)),
           tlinalg.cholesky_solve(_t(M), _t(b)), 1e-5)
    _close(jlinalg.inv_psd(Mj), tlinalg.inv_psd(_t(M)), 1e-5)


def test_smallest_eigvec_matches():
    # rank-8 9x9 PSD matrices (the 8-point normal matrix of a minimal
    # sample), nonzero spectrum in [1, 10]: the null vector is well posed
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(64, 9, 9)))
    lam = np.concatenate([np.zeros((64, 1)), rng.uniform(1, 10, (64, 8))], -1)
    M = ((Q * lam[:, None, :]) @ np.swapaxes(Q, -1, -2)).astype(np.float32)
    for iters in (3, 8):
        _close(jlinalg.smallest_eigvec(jnp.asarray(M), iters),
               tlinalg.smallest_eigvec(_t(M), iters), 1e-5)


def test_eigh3_svd3_match_with_signs():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(128, 3, 3)).astype(np.float32)
    S = A @ np.swapaxes(A, -1, -2)
    wj, Vj = jlinalg.eigh3(jnp.asarray(S))
    wt, Vt = tlinalg.eigh3(_t(S))
    _close(wj, wt, 1e-4)
    _close(Vj, Vt, 1e-5)  # same vectors, same signs
    Uj, Sj, VTj = jlinalg.svd3(jnp.asarray(A))
    Ut, St, VTt = tlinalg.svd3(_t(A))
    _close(Sj, St, 1e-5)
    _close(Uj, Ut, 1e-5)
    _close(VTj, VTt, 1e-5)
    # rank-2 (essential-like) input: the third left vector is the cross
    # product, whose sign the noise in s2 decides in both packages alike
    # (svd3 calls it free); every other output matches with its sign
    E = A.copy()
    E[:, :, 2] = E[:, :, 0] + E[:, :, 1]
    (Uj, Sj, VTj), (Ut, St, VTt) = jlinalg.svd3(jnp.asarray(E)), tlinalg.svd3(_t(E))
    _close(np.asarray(Sj)[..., :2], St[..., :2], 1e-4)
    # s2 = sqrt of a rounding-level eigenvalue: near zero on both sides
    assert float(np.max(np.asarray(Sj)[..., 2])) < 1e-2 and float(St[..., 2].max()) < 1e-2
    _close(VTj, VTt, 1e-4)
    _close(np.asarray(Uj)[..., :2], Ut[..., :2], 1e-4)
    _close(np.abs(np.asarray(Uj)[..., 2]), Ut[..., 2].abs(), 1e-4)
    np.testing.assert_allclose(tlinalg.det3(_t(A)).numpy(), np.linalg.det(A), atol=1e-4)


# ------------------------------------------------------------------ guards
def test_import_pulls_in_no_jax():
    code = ("import sys, aria_slam_tpu_torch.pipeline.factory, aria_slam_tpu_torch.convert;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'aria_slam_tpu' or m.startswith('aria_slam_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_port_file_imports_the_jax_package():
    # `aria_slam_tpu` followed by '.', whitespace or end: not the _torch prefix
    pat = re.compile(r"^\s*(from|import)\s+(aria_slam_tpu|jax)(\.|\s|$)", re.M)
    files = sorted((REPO / "aria_slam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_pipeline_without_device_needs_cuda(monkeypatch):
    from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlamPipeline(TORCH_SMALL_CFG)


@pytest.mark.parametrize("flag", ["enable_detection", "enable_dynamic_filtering"])
def test_unported_features_raise(flag):
    from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

    cfg = dataclasses.replace(TORCH_SMALL_CFG, **{flag: True})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SlamPipeline(cfg, device="cpu")


def test_kernel_wrappers_take_plain_path_only_on_cpu():
    """A non-CPU tensor never reaches the plain version: it goes to the
    kernel (or raises before launching)."""
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel

    meta = torch.zeros((1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        corner_kernel.corner_rank_map_batched(meta, 20.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        patch_kernel.extract_patches(meta, torch.zeros((1, 4, 2), device="meta"), 19)
    with pytest.raises(ValueError, match="CUDA tensor"):
        match_kernel.match_top2_batched(
            torch.zeros((1, 4, 256), dtype=torch.int8, device="meta"),
            torch.zeros((1, 4, 256), dtype=torch.int8, device="meta"),
            torch.zeros((1, 4), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        corner_kernel.corner_rank_maps([meta, torch.zeros((1, 8, 8), device="meta")], 20.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        patch_kernel.extract_patches_levels(
            [meta, torch.zeros((1, 8, 8), device="meta")],
            [torch.zeros((1, 4, 2), device="meta"), torch.zeros((1, 2, 2), device="meta")], 19)
    assert (corner_kernel.corner_rank_maps.launches
            == patch_kernel.extract_patches_levels.launches
            == match_kernel.match_top2_batched.launches == 0)
