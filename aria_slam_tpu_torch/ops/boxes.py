"""Box utilities: dynamic-object feature filtering and greedy NMS
(counterpart of the JAX package's ops/boxes.py).

Parity: the reference's isInDynamicObject match filter
(src/main.cpp:29-50, 164-175) and cv::dnn::NMSBoxes
(src/legacy/TRTInference.cpp:131). NMS keeps static shapes and never
reads the card from the host: it runs max_out rounds of plain tensor ops
(about 10 launches a round), with no early exit.
"""

from __future__ import annotations

import functools

import torch

from aria_slam_tpu_torch.core.types import Detections

# COCO ids of dynamic classes (reference src/main.cpp:29-40):
# person, bicycle, car, motorcycle, bus, train, truck, bird, cat, dog
DYNAMIC_CLASS_IDS = (0, 1, 2, 3, 5, 6, 7, 14, 15, 16)


@functools.lru_cache(maxsize=None)
def _dynamic_ids(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # made once a device: a host-to-device copy waits for the stream
    return torch.tensor(DYNAMIC_CLASS_IDS, dtype=dtype, device=device)


def points_in_dynamic_boxes(xy: torch.Tensor, det: Detections) -> torch.Tensor:
    """(..., K, 2) points, Detections with the same leading axes ->
    (..., K) bool: inside any valid box of a dynamic class."""
    ids = _dynamic_ids(det.classes.device, det.classes.dtype)
    active = det.valid & torch.isin(det.classes, ids)  # (..., D)
    b = det.boxes[..., None, :, :]                      # (..., 1, D, 4)
    x, y = xy[..., :, None, 0], xy[..., :, None, 1]     # (..., K, 1)
    inside = (x >= b[..., 0]) & (x <= b[..., 2]) & (y >= b[..., 1]) & (y <= b[..., 3])
    return torch.any(inside & active[..., None, :], dim=-1)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., D, 4) -> (..., D, D) pairwise IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float = 0.45, max_out: int | None = None) -> torch.Tensor:
    """Greedy class-agnostic NMS with static shapes: (..., D, 4) boxes,
    (..., D) scores and valid flags -> (..., D) bool keep mask.

    max_out rounds (default D) of "keep the best alive box, retire it and
    every box with IoU >= iou_threshold against it". torch.argmax takes
    the first maximal index, as jnp.argmax does. A box is its own
    suppressor (the diagonal is set), so a zero-area box is retired too."""
    d = boxes.shape[-2]
    max_out = max_out or d
    ar = torch.arange(d, device=boxes.device)
    suppress = (iou_matrix(boxes) >= iou_threshold) | (ar[:, None] == ar[None, :])
    alive = valid & (scores > 0)
    keep = torch.zeros_like(alive)
    for _ in range(max_out):
        best = torch.where(alive, scores, -1e30).argmax(-1, keepdim=True)  # (..., 1)
        # the best box is alive unless none is left
        keep |= (ar == best) & alive
        alive &= ~torch.take_along_dim(suppress, best[..., None], -2)[..., 0, :]
    return keep
