"""Plain greedy non-maximum suppression, as OpenCV's NMSBoxes runs it
(the reference system's TRTInference): visit the boxes by descending
score (ties to the lower index), keep a box that no kept box suppressed,
and suppress every box whose IoU with it is at least the threshold.
IoU in float64. Torch only; imports nothing of the program."""

from __future__ import annotations

import torch


def iou(boxes):
    """(D, 4) xyxy -> (D, D) IoU in float64."""
    b = boxes.double()
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    w = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    h = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = w * h
    return inter / (area[:, None] + area[None] - inter).clamp(min=1e-9)


def greedy(boxes, scores, valid, threshold):
    """(D, 4), (D,), (D,) -> (D,) bool keep mask; a box takes part when
    valid with a score above 0."""
    over = (iou(boxes) >= threshold).cpu()
    alive = (valid & (scores > 0)).cpu()
    order = sorted(range(len(scores)), key=lambda i: (-float(scores[i]), i))
    keep = torch.zeros(len(scores), dtype=torch.bool)
    gone = torch.zeros(len(scores), dtype=torch.bool)
    for i in order:
        if alive[i] and not gone[i]:
            keep[i] = True
            gone |= over[i]
    return keep.to(boxes.device)


def draw(rng, n, size, clusters=12):
    """n boxes (n, 4) xyxy in a size x size image, on whole pixels (so that
    every area and intersection is exact in float32), about `clusters`
    groups of overlapping boxes; distinct scores (n,) in (0, 1); about a
    tenth invalid. rng: a numpy Generator -> numpy arrays."""
    import numpy as np

    centres = rng.uniform(0.1 * size, 0.9 * size, (clusters, 2))
    c = centres[rng.integers(0, clusters, n)] + rng.normal(0.0, 0.03 * size, (n, 2))
    wh = rng.uniform(0.05 * size, 0.3 * size, (n, 2))
    lo = np.clip(np.round(c - wh / 2), 0, size - 2)
    hi = np.clip(np.maximum(np.round(c + wh / 2), lo + 1), 1, size - 1)
    boxes = np.concatenate([lo, hi], -1).astype(np.float32)
    scores = ((rng.permutation(n) + 1) / (n + 1)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return boxes, scores, valid
