"""Object detection: image -> Detections (counterpart of the JAX package's
models/detect.py).

Parity: the reference TRTInference (src/legacy/TRTInference.cpp):
resize to 640x640, grey to three channels, /255, inference, then the
confidence gate, cv::dnn::NMSBoxes and the box rescale to the input
image. Here the engine is models/yolo.Yolo in bfloat16 on the step's
device and NMS is ops/boxes.nms (plain tensor ops, no host read).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.core.types import Detections
from aria_slam_tpu_torch.models import yolo
from aria_slam_tpu_torch.ops import boxes as box_ops
from aria_slam_tpu_torch.ops.pyramid import _bilinear_matrix, _sep_matmul
from aria_slam_tpu_torch.ops.topk import top_k_stable
from aria_slam_tpu_torch.utils.profiling import span

# the random detector's seed when no model or weights are given: the JAX
# package's init_params(cfg) draws from jax.random.key(0)
DEFAULT_SEED = 0


def preprocess(images: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W) grey [0, 255] -> (N, 3, size, size) float32 [0, 1]:
    the bilinear resize of the reference's bf16-rounded banded matmuls,
    the grey level repeated in three channels (cvtColor GRAY2RGB)."""
    h, w = images.shape[-2:]
    norm = _sep_matmul(images, _bilinear_matrix(size, h), _bilinear_matrix(size, w)) / 255.0
    return norm.reshape(-1, 1, size, size).expand(-1, 3, size, size)


def _resolve_model(cfg: DetectorConfig, model, weights_path, device) -> yolo.Yolo:
    if model is None:
        if weights_path:
            model = yolo.load_weights(weights_path, cfg)
        else:
            model = yolo.init_model(cfg, DEFAULT_SEED)
    return model.to(device).eval()


def _postprocess(bxs, scores, cfg: DetectorConfig, h: int, w: int,
                 use_nms: bool = True) -> Detections:
    """(..., A, 4) boxes in detector px and (..., A, C) scores ->
    Detections in source-image px, max_detections of them. Gated-out
    anchors all have the key -1, so the selection keeps jax.lax.top_k's
    lower-index-first order among ties (top_k_stable)."""
    conf = torch.amax(scores, -1)
    cls = torch.argmax(scores, -1)  # the first maximal class, as jnp.argmax
    key = torch.where(conf >= cfg.conf_threshold, conf, -1.0)
    top_conf, top_idx = top_k_stable(key, cfg.max_detections)
    cand_boxes = torch.take_along_dim(bxs, top_idx[..., None], -2)
    cand_cls = torch.take_along_dim(cls, top_idx, -1).to(torch.int32)
    cand_valid = top_conf > 0.0
    top_conf = torch.clamp(top_conf, min=0.0)
    if use_nms:
        cand_valid = cand_valid & box_ops.nms(cand_boxes, top_conf, cand_valid,
                                              cfg.nms_iou_threshold)
    # (sx, sy, sx, sy) made on the device: a copy from the host would wait
    # for the stream
    scale = torch.full((4,), w / cfg.input_size, dtype=torch.float32, device=bxs.device)
    scale[1::2] = h / cfg.input_size
    return Detections(boxes=cand_boxes * scale, scores=top_conf, classes=cand_cls,
                      valid=cand_valid)


def _forward(model: yolo.Yolo, cfg: DetectorConfig, images: torch.Tensor):
    """(N, H, W) images -> ((N, A, 4) boxes, (N, A, C) scores)."""
    with torch.no_grad():
        outs = model(preprocess(images.to(torch.float32), cfg.input_size))
    return yolo.decode_predictions(outs, cfg.input_size, cfg.num_classes)


def make_detector(cfg: DetectorConfig, model: Optional[yolo.Yolo] = None,
                  weights_path: Optional[str] = None, device=None) -> Callable:
    """detect(image (H, W)) -> Detections of one frame, with NMS.

    model: a Yolo to use as it is; weights_path: an .npz in the JAX
    package's format (yolo.load_weights); else the JAX package's random
    weights of seed DEFAULT_SEED (yolo.init_model). Runs on CUDA unless `device`
    says otherwise. Spans (utils/profiling.span): detect.forward (the
    resize and the model), detect.post (the gate, the top-k and NMS)."""
    from aria_slam_tpu_torch.pipeline.slam_pipeline import resolve_device

    model = _resolve_model(cfg, model, weights_path, resolve_device(device))

    def detect(image: torch.Tensor) -> Detections:
        h, w = image.shape
        with span("detect.forward"):
            bxs, scores = _forward(model, cfg, image)
        with span("detect.post"):
            return _postprocess(bxs[0], scores[0], cfg, h, w)

    return detect


def make_batched_detector(cfg: DetectorConfig, model: Optional[yolo.Yolo] = None,
                          weights_path: Optional[str] = None, use_nms: bool = True,
                          device=None) -> Callable:
    """detect_batch(images (C, H, W)) -> Detections with a leading (C,)
    axis, from ONE forward pass over the batch: the chunked front end's
    shape (C + 1 frames of a chunk).

    use_nms=False skips NMS: the dynamic filter only tests point
    containment, which suppressed near-duplicate boxes do not change, and
    greedy NMS is max_detections sequential rounds. Spans
    (utils/profiling.span): detect.forward (the resize and the model),
    detect.post (the gate, the top-k and NMS when use_nms)."""
    from aria_slam_tpu_torch.pipeline.slam_pipeline import resolve_device

    model = _resolve_model(cfg, model, weights_path, resolve_device(device))

    def detect_batch(images: torch.Tensor) -> Detections:
        _, h, w = images.shape
        with span("detect.forward"):
            bxs, scores = _forward(model, cfg, images)
        with span("detect.post"):
            return _postprocess(bxs, scores, cfg, h, w, use_nms=use_nms)

    return detect_batch
