"""The port's weight converter (models/convert_weights.py) against the JAX
package's, on the ultralytics-named torch mirror of tests/test_convert.py
(a minimal YOLOv8 with DetectionModel's state_dict names): the port's
float32 model reproduces the mirror's outputs at test_convert.py's
tolerance, its npz equals the JAX conversion key by key, the error cases
raise the reference's exception types, and a model written out under
ultralytics names converts back bit for bit."""

import numpy as np
import pytest
import torch

import flax.traverse_util as tu

import tests.test_convert as mirror
from aria_slam_tpu.models import convert_weights as jcw
from aria_slam_tpu.models import yolo as jyolo
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.models import convert_weights as tcw
from aria_slam_tpu_torch.models import yolo

import torch_parity_util  # noqa: F401  (two torch threads a worker)

CFG = DetectorConfig(input_size=64, width_mult=mirror.W, depth_mult=mirror.D,
                     num_classes=mirror.NC)


@pytest.fixture(scope="module")
def torch_model():
    return mirror.make_torch_model()


@pytest.fixture(scope="module")
def jax_npz(torch_model, tmp_path_factory):
    """The JAX package's conversion of the mirror, as its npz."""
    path = str(tmp_path_factory.mktemp("jconv") / "j.npz")
    jyolo.save_weights(jcw.convert_state_dict(torch_model.state_dict(), mirror.CFG), path)
    with np.load(path) as f:
        return dict(f)


def test_mapping_equals_reference():
    for depth in (0.33, 0.67, 1.0):
        assert tcw.build_mapping(depth) == jcw.build_mapping(depth)
    assert (tcw._SKIP_PREFIXES, tcw._SKIP_SUFFIXES) == (jcw._SKIP_PREFIXES, jcw._SKIP_SUFFIXES)


def test_converted_model_matches_the_mirror(torch_model):
    """The port's model from convert_state_dict, its variables loaded into
    a float32 model, against the mirror's torch outputs (test_convert.py's
    atol 2e-4, rtol 1e-3)."""
    converted = tcw.convert_state_dict(torch_model.state_dict(), CFG)
    assert not converted.training
    model = convert.yolo_from_flax(convert.yolo_to_flax(converted),
                                   yolo.make_model(CFG, torch.float32))
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 3, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        want = torch_model(x)
        got = model(x)
    assert len(got) == len(want) == 3
    for lvl, ((gb, gc), (wb, wc)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gb.numpy(), wb.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=f"box level {lvl}")
        np.testing.assert_allclose(gc.numpy(), wc.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=f"cls level {lvl}")


@pytest.mark.parametrize("form", ["state_dict", "checkpoint", "module"])
def test_convert_file_equals_reference(torch_model, jax_npz, tmp_path, form):
    """convert_file on the three checkpoint forms the reference reads (a
    raw state_dict, {"model": module}, a module) writes the JAX
    conversion's npz, key by key and bit for bit."""
    obj = {"state_dict": torch_model.state_dict(), "checkpoint": {"model": torch_model},
           "module": torch_model}[form]
    pt, out = str(tmp_path / "m.pt"), str(tmp_path / "m.npz")
    torch.save(obj, pt)
    tcw.convert_file(pt, out, CFG)
    with np.load(out) as f:
        got = dict(f)
    assert set(got) == set(jax_npz)
    for k, w in jax_npz.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_cli_writes_the_npz(torch_model, jax_npz, tmp_path):
    pt, out = str(tmp_path / "sd.pt"), str(tmp_path / "cli.npz")
    torch.save(torch_model.state_dict(), pt)
    tcw.main([pt, out, "--width", str(mirror.W), "--depth", str(mirror.D),
              "--classes", str(mirror.NC)])
    with np.load(out) as f:
        assert all(np.array_equal(f[k], w) for k, w in jax_npz.items())
    loaded = jyolo.load_weights(out)
    _, ref = jyolo.init_params(mirror.CFG)
    assert set(tu.flatten_dict(loaded)) == set(tu.flatten_dict(ref))


def _drop(sd, key):
    return {k: v for k, v in sd.items() if k != key}


CASES = {
    "shape mismatch": lambda sd, mp: ({**sd, "model.0.conv.weight": torch.zeros(99, 3, 3, 3)},
                                      mp),
    "missing key": lambda sd, mp: (_drop(sd, "model.9.cv1.conv.weight"), mp),
    "unconsumed": lambda sd, mp: ({**sd, "model.23.extra.weight": torch.zeros(3)}, mp),
    "not covered": lambda sd, mp: (_drop(sd, mp[-1][0]), mp[:-1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_errors_raise_the_references_types(torch_model, monkeypatch, case):
    """A wrong width or depth, a missing key, an extra checkpoint key and
    a mapping that leaves a variable uncovered: the port raises the
    exception type the reference raises."""
    raised = []
    for mod, cfg in ((jcw, mirror.CFG), (tcw, CFG)):
        sd, mapping = CASES[case](torch_model.state_dict(), mod.build_mapping(cfg.depth_mult))
        monkeypatch.setattr(mod, "build_mapping", lambda depth, m=mapping: m)
        with pytest.raises((KeyError, ValueError)) as err:
            mod.convert_state_dict(sd, cfg)
        raised.append(err.type)
    assert raised[0] is raised[1], raised
    assert raised[0] is (KeyError if case == "missing key" else ValueError)


def test_ultralytics_round_trip_is_exact():
    """init_model's bf16 detector written out under ultralytics names and
    converted back: the same variables, and the same outputs bit for bit."""
    cfg = DetectorConfig(input_size=64, width_mult=0.25, depth_mult=0.33, num_classes=3)
    model = yolo.init_model(cfg, 0)
    sd = tcw.ultralytics_state_dict(model, cfg)
    assert all(k.startswith("model.") for k in sd)
    back = tcw.convert_state_dict(sd, cfg)
    want = convert.yolo_to_flax(model)
    got = convert.yolo_to_flax(back)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], w) for k, w in want.items())
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 3, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        for (gb, gc), (wb, wc) in zip(back(x), model(x)):
            assert torch.equal(gb, wb) and torch.equal(gc, wc)
