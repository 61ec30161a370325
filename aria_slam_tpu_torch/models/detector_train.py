"""Detector training (counterpart of the JAX package's
models/detector_train.py): anchor-free assignment, BCE classification
and distribution focal loss over the box bins, trained with Adam, on the
synthetic-shapes task (`train`) or on a rendered scene's moving object
from its ground-truth boxes (`train_on_scene`, which
eval/dynamic_benchmark.py runs).

The reference trains the flax model with optax; here the port's
models/yolo.Yolo trains with torch.optim.Adam (the same update as
optax.adam: bias-corrected moments, eps outside the square root). The
model holds float32 kernels and computes in bf16 (`param_dtype`), batch
norm runs in train mode with its batch statistics, and the running
averages are buffers, not optimiser state. `train` starts from the JAX
package's init for the same seed (yolo.init_model) and draws the same
batches from np.random.default_rng(seed), so the two packages train from
the same weights on the same data.

The head maps are NCHW here: a level's box map is (B, 4 reg_max, h, w)
with the four sides major and the bins minor along the channels, as
yolo.decode_predictions reads it; the loss moves channels last before it
reads anchors row-major, as the reference does.

The reference resizes scene frames with cv2.resize(INTER_AREA); the port
has no OpenCV and resizes with `resize_area`, OpenCV's per-axis weights
in numpy (within about 3e-5 of OpenCV on the 0-255 scale).

Train on the card and write the JAX package's weight file:

    python -m aria_slam_tpu_torch.models.detector_train --steps 600 \\
        --out shapes_tiny.npz
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.models import yolo

REG_MAX = 16


# ------------------------------------------------------------- synthetic data
def make_synthetic_batch(rng: np.random.Generator, batch: int, size: int,
                         max_boxes: int = 4, num_classes: int = 2):
    """Images with solid rectangles (class 0) and ellipses (class 1) on
    textured noise. Returns (images (B,S,S,3) [0,1], boxes (B,M,4) xyxy,
    cls (B,M), valid (B,M)): the reference's arrays for the same rng."""
    imgs = rng.uniform(0.0, 0.45, (batch, size, size, 3)).astype(np.float32)
    # low-frequency texture so the background isn't trivially separable
    for b in range(batch):
        gx = rng.uniform(0, 0.25)
        imgs[b] += gx * np.sin(np.arange(size) / rng.uniform(3, 9))[None, :, None]
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    cls = np.zeros((batch, max_boxes), np.int32)
    valid = np.zeros((batch, max_boxes), bool)
    yy, xx = np.mgrid[0:size, 0:size]
    for b in range(batch):
        n = rng.integers(1, max_boxes + 1)
        for m in range(n):
            w = rng.integers(size // 5, size // 2)
            h = rng.integers(size // 5, size // 2)
            x1 = rng.integers(0, size - w)
            y1 = rng.integers(0, size - h)
            c = int(rng.integers(0, num_classes))
            color = rng.uniform(0.55, 1.0, 3).astype(np.float32)
            if c == 0:
                imgs[b, y1:y1 + h, x1:x1 + w] = color
            else:
                cx, cy = x1 + w / 2, y1 + h / 2
                mask = ((xx - cx) / (w / 2)) ** 2 + ((yy - cy) / (h / 2)) ** 2 <= 1
                imgs[b][mask] = color
            boxes[b, m] = [x1, y1, x1 + w, y1 + h]
            cls[b, m] = c
            valid[b, m] = True
    return np.clip(imgs, 0, 1), boxes, cls, valid


# ------------------------------------------------------------------- the loss
def _level_loss(box_dfl, cls_logits, stride: int, gt_boxes, gt_cls, gt_valid,
                num_classes: int, lo: float, hi: float):
    """One level's assignment and loss over the batch. box_dfl (B, 4 R, h,
    w), cls_logits (B, C, h, w); gt_boxes (B, M, 4), gt_cls (B, M),
    gt_valid (B, M). Returns (cls_loss_sum, box_loss_sum, num_pos)."""
    b, _, h, w = cls_logits.shape
    dev = cls_logits.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * stride
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * stride
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    ax = gx.reshape(1, -1, 1)  # (1, A, 1)
    ay = gy.reshape(1, -1, 1)

    x1, y1, x2, y2 = gt_boxes.unbind(-1)  # (B, M)
    bw, bh = x2 - x1, y2 - y1
    side = torch.maximum(bw, bh)
    size_ok = (side >= lo) & (side < hi) & gt_valid  # (B, M)
    # positive: anchor centre inside the central 60 % of the box
    inside = ((ax > (x1 + 0.2 * bw)[:, None]) & (ax < (x2 - 0.2 * bw)[:, None])
              & (ay > (y1 + 0.2 * bh)[:, None]) & (ay < (y2 - 0.2 * bh)[:, None]))  # (B, A, M)
    cand = inside & size_ok[:, None]
    inf = torch.tensor(float("inf"), device=dev)
    area = torch.where(size_ok, bw * bh, inf)
    # ambiguous anchors take the smallest candidate box (the first of equals)
    best = torch.argmin(torch.where(cand, area[:, None], inf), -1)  # (B, A)
    posf = cand.any(-1).float()
    num_pos = posf.sum()

    # classification: BCE over every anchor, one-hot at the matched class
    cls_t = F.one_hot(torch.gather(gt_cls.long(), 1, best), num_classes) * posf[..., None]
    logits = cls_logits.permute(0, 2, 3, 1).reshape(b, h * w, num_classes).float()
    cls_loss = torch.sum(torch.clamp(logits, min=0) - logits * cls_t
                         + torch.log1p(torch.exp(-logits.abs())))

    # DFL box regression on positives: two-hot CE over the bins
    def at_best(v):
        return torch.gather(v, 1, best)

    ax, ay = ax[..., 0], ay[..., 0]
    dist = torch.stack([ax - at_best(x1), ay - at_best(y1),
                        at_best(x2) - ax, at_best(y2) - ay], -1) / stride  # (B, A, 4)
    dist = torch.clamp(dist, 0.0, REG_MAX - 1 - 1e-3)
    dl = torch.floor(dist)
    wr = dist - dl
    dl = dl.long()
    logp = torch.log_softmax(
        box_dfl.permute(0, 2, 3, 1).reshape(b, h * w, 4, REG_MAX).float(), -1)
    lp_lo = torch.gather(logp, -1, dl[..., None])[..., 0]
    lp_hi = torch.gather(logp, -1, (dl + 1)[..., None])[..., 0]
    box_loss = -torch.sum(((1 - wr) * lp_lo + wr * lp_hi) * posf[..., None])
    return cls_loss, box_loss, num_pos


def detection_loss(outs, gt_boxes, gt_cls, gt_valid, input_size: int, num_classes: int):
    """Total loss over levels and batch. outs: the model's per-level (box,
    cls) NCHW maps; gt_* as in _level_loss, on the maps' device."""
    strides = [input_size // cls.shape[2] for _, cls in outs]
    # size routing: level l takes boxes with max side in [4s, 4s_next)
    cls_sum = box_sum = pos_sum = 0.0
    for i, ((box, cls), stride) in enumerate(zip(outs, strides)):
        lo = 0.0 if i == 0 else 4.0 * stride
        hi = float("inf") if i == len(strides) - 1 else 4.0 * strides[i + 1]
        c, b, p = _level_loss(box, cls, stride, gt_boxes, gt_cls, gt_valid, num_classes, lo, hi)
        cls_sum = cls_sum + c
        box_sum = box_sum + b
        pos_sum = pos_sum + p
    denom = torch.clamp(pos_sum, min=1.0)
    return cls_sum / denom + 0.5 * box_sum / denom


# ------------------------------------------------- scene (dynamic-object) data
def load_scene_boxes(scene_dir: str):
    """Read mav0/cam0/boxes.csv written by io/synthetic_scene.generate
    (moving_object=True). Returns {ts_ns: (x1, y1, x2, y2)}."""
    import os

    path = os.path.join(scene_dir, "mav0", "cam0", "boxes.csv")
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, x1, y1, x2, y2 = line.split(",")
            out[int(ts)] = (float(x1), float(y1), float(x2), float(y2))
    return out


def _area_weights(src: int, dst: int, area: bool) -> np.ndarray:
    """(dst, src) weights of one axis of cv2.resize(INTER_AREA), float32
    as OpenCV holds them. area (both axes shrink): computeResizeAreaTab's
    cells, each of width min(scale, src - fsx1), a partial edge cell kept
    only above 1e-3. Otherwise OpenCV's linear path in its area mode: two
    taps at floor(d * scale), the second weighted by the fractional part
    of (d + 1) - (sx + 1) / scale, indices clamped to the edge."""
    inv = dst / src
    scale = 1.0 / inv  # OpenCV's scale_x, as it derives it
    w = np.zeros((dst, src), np.float32)
    for d in range(dst):
        if area:
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, src - f1)
            s2 = min(int(np.floor(f2)), src - 1)
            s1 = min(int(np.ceil(f1)), s2)
            if s1 - f1 > 1e-3:
                w[d, s1 - 1] += np.float32((s1 - f1) / cell)
            w[d, s1:s2] += np.float32(1.0 / cell)
            if f2 - s2 > 1e-3:
                w[d, s2] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
        else:
            s = int(np.floor(d * scale))
            f = np.float32((d + 1) - (s + 1) * inv)
            f = np.float32(0.0) if f <= 0 else f - np.float32(np.floor(f))
            w[d, min(max(s, 0), src - 1)] += np.float32(1.0) - f
            w[d, min(max(s + 1, 0), src - 1)] += f
    return w


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA) of a
    float32 (H, W) image in numpy, as separable per-axis weights (rows,
    then columns) accumulated in float64. Within about 3e-5 of OpenCV on
    the 0-255 scale (OpenCV sums in float32, in its own order), not
    bit-equal."""
    h, w = img.shape
    area = w >= width and h >= height
    wx = _area_weights(w, width, area).astype(np.float64)
    wy = _area_weights(h, height, area).astype(np.float64)
    return (wy @ (img.astype(np.float64) @ wx.T)).astype(np.float32)


def make_scene_batch(rng: np.random.Generator, frames, boxes, batch: int,
                     size: int, max_boxes: int = 4):
    """Training batch from rendered scene frames + their GT object box.

    frames: list of (H, W) grayscale [0,255]; boxes: aligned list of
    (x1,y1,x2,y2) or None. Light augmentation (flip + brightness/
    contrast jitter) -- the detector only needs to generalize across the
    object's own pose changes within one scene. The reference's arrays for
    the same rng, its draws in its order; the area resize is resize_area."""
    h, w = frames[0].shape
    imgs = np.zeros((batch, size, size, 3), np.float32)
    gt_boxes = np.zeros((batch, max_boxes, 4), np.float32)
    gt_cls = np.zeros((batch, max_boxes), np.int32)
    gt_valid = np.zeros((batch, max_boxes), bool)
    sx, sy = size / w, size / h
    for b in range(batch):
        i = int(rng.integers(0, len(frames)))
        img = resize_area(frames[i].astype(np.float32), size, size)
        bb = boxes[i]
        if bb is not None:
            x1, y1, x2, y2 = bb[0] * sx, bb[1] * sy, bb[2] * sx, bb[3] * sy
        if rng.random() < 0.5:
            img = img[:, ::-1]
            if bb is not None:
                x1, x2 = size - x2, size - x1
        img = np.clip(img * rng.uniform(0.8, 1.2) + rng.uniform(-15, 15),
                      0, 255) / 255.0
        imgs[b] = img[..., None]
        if bb is not None and x2 - x1 > 3 and y2 - y1 > 3:
            gt_boxes[b, 0] = [x1, y1, x2, y2]
            gt_cls[b, 0] = 0  # class 0 == COCO "person" (dynamic)
            gt_valid[b, 0] = True
    return imgs, gt_boxes, gt_cls, gt_valid


def scene_boxes(data, box_map):
    """The box of each of data's frames, or None: data.image_ts went
    through float64 seconds (ulp ~0.25 us at the EuRoC epoch), so the ns
    key cannot be rebuilt exactly -- matched within 10 us."""
    keys = np.array(sorted(box_map))
    boxes = []
    for ts in data.image_ts:
        tns = ts * 1e9
        j = int(np.searchsorted(keys, tns))
        best = None
        for jj in (j - 1, j):
            if 0 <= jj < len(keys) and abs(float(keys[jj]) - tns) < 1e4:
                best = box_map[int(keys[jj])]
        boxes.append(best)
    return boxes


def train_on_scene(cfg: DetectorConfig, scene_dir: str, steps: int = 800, batch: int = 8,
                   lr: float = 3e-3, seed: int = 0, verbose: bool = False,
                   device=None) -> yolo.Yolo:
    """Train the detector to find the scene's moving object (class 0 =
    person, a DYNAMIC_CLASS_IDS member) from the scene's ground-truth
    boxes, from init_model(cfg, seed) on `device` (CUDA unless asked
    otherwise), on the reference's batches for the same seed. Returns the
    model in eval mode, float32 kernels and bf16 compute."""
    from aria_slam_tpu_torch.io import euroc
    from aria_slam_tpu_torch.pipeline.slam_pipeline import resolve_device

    device = resolve_device(device)
    data = euroc.load(scene_dir)
    frames = [euroc.load_image(p) for p in data.image_paths]
    boxes = scene_boxes(data, load_scene_boxes(scene_dir))
    model = yolo.init_model(cfg, seed, param_dtype=torch.float32).to(device)
    step = make_train_step(model, adam(model, lr), cfg.input_size, cfg.num_classes)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        loss = step(*make_scene_batch(rng, frames, boxes, batch, cfg.input_size))
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"scene-train step {i}: loss {float(loss):.4f}", flush=True)
    return model.eval()


# --------------------------------------------------------------- the trainer
def make_train_step(model: yolo.Yolo, optimizer, input_size: int, num_classes: int):
    """step(imgs (B, S, S, 3), boxes, cls, valid) -> loss before the update:
    the model (on its device) in train mode through detection_loss, the
    backward pass and `optimizer`, numpy arrays or tensors in the
    reference's layout. A float32 model keeps TF32 off in its backward
    convolutions too."""
    device = next(model.parameters()).device

    def step(imgs, boxes, cls, valid):
        model.train()
        x = torch.as_tensor(imgs, device=device).permute(0, 3, 1, 2)
        gt = [torch.as_tensor(a, device=device) for a in (boxes, cls, valid)]
        optimizer.zero_grad(set_to_none=True)
        with yolo.fp32_convolutions(model.dtype, device):
            loss = detection_loss(model(x), *gt, input_size, num_classes)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def adam(model: yolo.Yolo, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) for the model's parameters."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train(cfg: DetectorConfig, steps: int = 600, batch: int = 8, lr: float = 2e-3,
          seed: int = 0, verbose: bool = False, device=None) -> yolo.Yolo:
    """Train on the synthetic-shapes task from init_model(cfg, seed) on
    `device` (CUDA unless asked otherwise); returns the model in eval
    mode, float32 kernels and bf16 compute."""
    from aria_slam_tpu_torch.pipeline.slam_pipeline import resolve_device

    device = resolve_device(device)
    model = yolo.init_model(cfg, seed, param_dtype=torch.float32).to(device)
    step = make_train_step(model, adam(model, lr), cfg.input_size, cfg.num_classes)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        imgs, boxes, cls, valid = make_synthetic_batch(
            rng, batch, cfg.input_size, num_classes=cfg.num_classes)
        loss = step(imgs, boxes, cls, valid)
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"step {i}: loss {float(loss):.4f}", flush=True)
    return model.eval()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="train the shapes detector")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--classes", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out", required=True, help="output weights .npz")
    args = ap.parse_args(argv)
    cfg = DetectorConfig(input_size=args.size, width_mult=args.width, depth_mult=0.33,
                         num_classes=args.classes)
    model = train(cfg, args.steps, args.batch, verbose=True, device=args.device)
    yolo.save_weights(model, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
