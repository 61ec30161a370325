"""The check fails a run whose timed path is broken underneath: a run at
the small size on the CPU, past the harness's look for a card, with the
program patched to (a) return a step's state unchanged (the pose solver
hands back its first answer every time), (b) leave out half of the batch
(the second half of the frames' keypoints invalid), (c) alter an answer
where it is produced (the matcher's best index of a few rows), and in
the pose solver: (d) the second half of its pairs reported failed (a
batch slot, or a chunk's lag pairs), (e) the gyro's rotation handed on
transposed; in the full cell also (f) a few keypoints of every frame
flagged as on a moving object. The cells run on one chip, so no
exchange between chips can be left out. An unbroken run passes."""

import pytest
import torch

from slam_bench.tests import small

CELLS = ("full_c32.rotloop_moving", "vo_batch11.sweep")


def stale(fn):
    first = []

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if not first:
            # a copy: the evaluator replaces the host-read entries in place
            first.append(dict(out) if isinstance(out, dict) else out)
        return dict(first[0]) if isinstance(out, dict) else first[0]
    return wrapped


def half(fn):
    def wrapped(frames, cfg):
        feats = fn(frames, cfg)
        n = feats.valid.shape[0]
        valid = feats.valid.clone()
        valid[n // 2:] = False
        return feats.replace(valid=valid)
    return wrapped


def altered(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        best, second, idx = out if isinstance(out, tuple) else (None, None, None)
        if idx is None:
            return out.__class__(out.query_idx, (out.train_idx + 1) % out.train_idx.shape[-1],
                                 out.distance, out.valid)
        idx = idx.clone()
        idx[..., :5] = (idx[..., :5] + 1) % idx.shape[-1]
        return best, second, idx
    return wrapped


def cleared(fn):
    def wrapped(*a, **k):
        delta = fn(*a, **k)
        ok = delta.success.clone()
        ok[ok.shape[0] // 2:] = False
        return delta.replace(success=ok)
    return wrapped


def transposed(fn):
    def wrapped(*a, **k):
        delta = fn(*a, **k)
        return delta.replace(R=delta.R.transpose(-1, -2))
    return wrapped


def flagged(fn):
    def wrapped(xy, det):
        dyn = fn(xy, det).clone()
        dyn[..., :10] = True
        return dyn
    return wrapped


def patches(cell, fault, monkeypatch):
    from aria_slam_tpu_torch.eval import chunked, multi_eval
    from aria_slam_tpu_torch.ops import boxes, epipolar, match

    common = {"cleared": (epipolar, "estimate_pose_gyro_fused", cleared),
              "transposed": (epipolar, "estimate_pose_gyro_fused", transposed)}

    if cell.startswith("full"):
        targets = {"stale": (chunked, "pairs", stale), "half": (chunked, "extract", half),
                   "altered": (match, "match_batched_raw", altered),
                   "flagged": (boxes, "points_in_dynamic_boxes", flagged), **common}
    else:
        def stale_frontend(cfg, _make=multi_eval.make_multi_chunk_frontend):
            return stale(_make(cfg))
        targets = {"stale": (multi_eval, "make_multi_chunk_frontend", lambda f: stale_frontend),
                   "half": (multi_eval, "extract", half),
                   "altered": (match, "match_batched", altered), **common}
    mod, name, wrap = targets[fault]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(cell):
    result, checks, _ = small.run(cell)
    assert result["correct"], checks


FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("stale", "half", "altered", "cleared", "transposed")]
FAULTS.append(("full_c32.rotloop_moving", "flagged"))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    torch.manual_seed(0)
    patches(cell, fault, monkeypatch)
    result, checks, _ = small.run(cell)
    assert not result["correct"], checks
