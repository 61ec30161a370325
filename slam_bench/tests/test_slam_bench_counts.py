"""The count functions reproduce the port's kernel table (PERF.md): the
least times of the corner kernel at B = 33 (0.0881 ms, bytes), the patch
kernel at B = 33 (0.1388 ms, bytes) on the chunked phase's first 33
sweep frames, and the match kernel at N = 32 (0.0331 ms, operations)."""

import numpy as np
import pytest
import torch

from slam_bench import counts
from slam_bench.reference import orb as ref_orb
from slam_bench.scene import render

ORB = dict(num_features=2000, num_levels=8, scale_factor=1.2, fast_threshold=20.0,
           harris_block_size=7, patch_size=31, edge_threshold=31, descriptor_bits=256,
           brief_seed=2024)


def test_match_bound_n32():
    assert round(counts.match_bound(32, 2000, 2000) * 1e3, 4) == 0.0331


def test_corner_bytes_bound_b33():
    levels = ref_orb.pyramid(torch.zeros(1, 480, 752), 8, 1.2)
    ms = 33 * counts.corner_bytes(levels) / counts.HBM_BYTES_PER_S * 1e3
    assert round(ms, 4) == 0.0881


def test_patch_bytes_bound_b33():
    cam = render.Camera()
    frames = render.render(cam, np.arange(33) / 10.0, render.scene_layers(4.0, 0),
                           device="cpu")
    quotas = ref_orb.quotas(2000, 8, 1.2)
    total = 0
    for f in range(33):
        levels = ref_orb.pyramid(torch.from_numpy(frames[f:f + 1]).float(), 8, 1.2)
        blurred, xys = [], []
        for lvl, q in zip(levels, quotas):
            _, h, w = lvl.shape
            rank = ref_orb.rank_map(lvl, 20.0, 7)
            rank[:, :31] = rank[:, h - 31:] = float("-inf")
            rank[:, :, :31] = rank[:, :, w - 31:] = float("-inf")
            _, idx = torch.topk(rank.reshape(1, -1), q, dim=-1)
            xys.append(torch.stack([(idx % w).float(), (idx // w).float()], -1))
            blurred.append(ref_orb.separable(lvl, ref_orb.box_matrix(h), ref_orb.box_matrix(w)))
        total += counts.patch_bytes(blurred, xys, ref_orb.PATCH_R)
    ms = total / counts.HBM_BYTES_PER_S * 1e3
    # the table rounds to 4 places; keypoint ties at a quota's last place
    # may move a patch by a pixel between the card's rank maps and these
    assert ms == pytest.approx(0.1388, abs=1e-4), ms


def test_yolo_s_flops_at_640():
    # YOLOv8s' published 28.6 GFLOPs at 640 px
    assert round(counts.yolo_flops(640) / 1e9, 1) == 28.6


def test_brief_least_work_is_its_patches_bytes():
    # 2000 keypoints: 39 x 39 float32 pixels read, 32 bytes of bits and an
    # angle written each; 4 x 709 moment operations and 256 compares each
    # stay far under float32's peak at that traffic
    want = 2000 * (4 * 39 * 39 + 32 + 4) / counts.HBM_BYTES_PER_S
    assert counts.brief_least_s(2000) == pytest.approx(want, rel=1e-12)
    assert 2000 * (4 * 709 + 256) / counts.F32_OPS_PER_S < want
