"""YOLO-class anchor-free object detector as torch modules (counterpart of
the JAX package's models/yolo.py, a flax model).

Parity: the reference runs YOLO26s through TensorRT
(src/legacy/TRTInference.cpp: 640x640 input, [1, 300, 6] output). The
model is the JAX package's: a CSP backbone of C2f blocks, SPPF, a PAN-FPN
neck and a decoupled anchor-free head with distribution-focal box
regression. Layout is NCHW with (out, in, kh, kw) kernels where flax has
NHWC and (kh, kw, in, out); every concatenation runs over the channels
in flax's order.

Names: every submodule is registered under the name flax gives it
(`ConvBnAct_3`, `Bottleneck_0`, numbered per class in creation order),
and `Conv` / `BatchNorm` hold flax's parameter names, so a state_dict key
is the flax variable path with "." for "/". `convert.yolo_from_flax`
maps the JAX package's variables (the `.npz` of its `yolo.save_weights`)
onto a `Yolo`; `load_weights` / `save_weights` read and write that file.

Numbers: the detector computes in bfloat16 on purpose, rounding where
flax rounds with `dtype=bfloat16`: a convolution takes bf16 input and
kernel and gives bf16 (its bias, in the head, is a bf16 add after it);
batch norm computes (x - mean) * rsqrt(var + 1e-3) * scale + bias in
float32 from the bf16 input and rounds once; SiLU and the residual add
run on bf16; `decode_predictions` casts to float32 first. Batch norm is
not folded into the kernels, which would move those rounding points. A
float32 model on the card runs its convolutions with cuDNN's TF32 off
(`fp32_convolutions`, which a training step also holds around its
backward pass).

Training (models/detector_train.py): in train mode (`model.train()`)
batch norm normalises with the batch's statistics as flax's
`BatchNorm(use_running_average=False)` does (float32, the fast variance
E[x^2] - E[x]^2 clipped at 0, biased, gradients through both) and
updates the running averages as 0.99 old + 0.01 batch; `stats_group`
makes the statistics those of the whole batch over a process group
(parallel/multiseq.py). A model to train holds its kernels in float32
(`param_dtype`) and rounds them to the compute dtype at every call, as
flax does: held in bf16, Adam's small steps would round away.

Random weights: `init_model(cfg, seed)` is the JAX package's
`init_params(cfg, jax.random.key(seed))`, drawn in numpy by
models/flax_init.py (lecun-normal kernels, zero biases, batch norm scale
1, bias 0, mean 0, var 1); `init_params` returns the model with the
variables in flax's tree, as the JAX function does.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.models import flax_init


def _ch(c: int, w: float) -> int:
    return max(16, int(round(c * w / 8)) * 8)


def _n(d: int, mult: float) -> int:
    return max(1, int(round(d * mult)))


class Conv(nn.Module):
    """flax nn.Conv without dilation or groups: `kernel` (out, in, k, k),
    symmetric padding, an optional `bias` added after the convolution in
    the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 1, pad: int = 0,
                 bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.pad = s, pad

    def forward(self, x):
        y = F.conv2d(x, self.kernel.to(x.dtype), stride=self.stride, padding=self.pad)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.99, epsilon=1e-3): float32 arithmetic
    on the input, one rounding to its dtype. In eval mode it normalises
    with the running averages; in train mode with the batch's mean and
    fast variance, summed over `stats_group` when one is set (per-channel
    sums, sums of squares and counts, so the statistics are the whole
    batch's however it is split), and updates the running averages."""

    momentum = 0.99

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.eps = eps
        self.stats_group = None

    def batch_stats(self, xf: torch.Tensor):
        """(mean, var) over every axis but the channels of float32 xf."""
        c = xf.shape[1]
        sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                          xf.new_full((1,), xf.numel() // c)])
        if self.stats_group is not None:
            sums = dist_nn.all_reduce(sums, group=self.stats_group)
        mean, mean2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, var = self.batch_stats(xf)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class _Compact(nn.Module):
    """A module whose children are registered in creation order under
    flax's automatic names, and consumed in that order by forward()."""

    def __init__(self):
        super().__init__()
        self._counts: dict = {}

    def sub(self, m: nn.Module) -> None:
        kind = type(m).__name__
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", m)


class ConvBnAct(_Compact):
    def __init__(self, cin: int, out: int, k: int = 3, s: int = 1):
        super().__init__()
        # symmetric k // 2 padding (ultralytics autopad), as the reference
        self.sub(Conv(cin, out, k, s, k // 2))
        self.sub(BatchNorm(out))

    def forward(self, x):
        conv, bn = self.children()
        return F.silu(bn(conv(x)))


class Bottleneck(_Compact):
    def __init__(self, cin: int, out: int, shortcut: bool = True):
        super().__init__()
        self.residual = shortcut and cin == out
        self.sub(ConvBnAct(cin, out, 3))
        self.sub(ConvBnAct(out, out, 3))

    def forward(self, x):
        a, b = self.children()
        y = b(a(x))
        return x + y if self.residual else y


class C2f(_Compact):
    """Cross-stage partial block with n bottlenecks (YOLOv8-style)."""

    def __init__(self, cin: int, out: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        h = out // 2
        self.h = h
        self.sub(ConvBnAct(cin, 2 * h, 1))
        for _ in range(n):
            self.sub(Bottleneck(h, h, shortcut))
        self.sub(ConvBnAct((2 + n) * h, out, 1))

    def forward(self, x):
        first, *blocks, last = self.children()
        y = first(x)
        parts = [y[:, :self.h], y[:, self.h:]]
        for b in blocks:
            parts.append(b(parts[-1]))
        return last(torch.cat(parts, 1))


class SPPF(_Compact):
    def __init__(self, cin: int, out: int):
        super().__init__()
        h = out // 2
        self.sub(ConvBnAct(cin, h, 1))
        self.sub(ConvBnAct(4 * h, out, 1))

    def forward(self, x):
        first, last = self.children()
        x = first(x)
        # flax max_pool 5x5, stride 1, "SAME": -inf padding of 2
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return last(torch.cat([x, p1, p2, p3], 1))


def _upsample2(x):
    """Nearest x2: output row i reads input row i // 2 (jax.image.resize
    "nearest" at an exact factor of 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloBackboneNeck(_Compact):
    def __init__(self, width: float = 0.5, depth: float = 0.33):
        super().__init__()
        c1, c2, c3, c4, c5 = (_ch(c, width) for c in (64, 128, 256, 512, 1024))
        n3, n6 = _n(3, depth), _n(6, depth)
        self.channels = (c3, c4, c5)
        for m in (ConvBnAct(3, c1, 3, 2), ConvBnAct(c1, c2, 3, 2), C2f(c2, c2, n3),  # /4
                  ConvBnAct(c2, c3, 3, 2), C2f(c3, c3, n6),                          # /8
                  ConvBnAct(c3, c4, 3, 2), C2f(c4, c4, n6),                          # /16
                  ConvBnAct(c4, c5, 3, 2), C2f(c5, c5, n3), SPPF(c5, c5),            # /32
                  # PAN neck
                  C2f(c5 + c4, c4, n3, False), C2f(c4 + c3, c3, n3, False),
                  ConvBnAct(c3, c3, 3, 2), C2f(c3 + c4, c4, n3, False),
                  ConvBnAct(c4, c4, 3, 2), C2f(c4 + c5, c5, n3, False)):
            self.sub(m)

    def forward(self, x):
        (s2, s4, c4, s8, c8, s16, c16, s32, c32, sppf,
         up4, up3, down4, pan4, down5, pan5) = self.children()
        p3 = c8(s8(c4(s4(s2(x)))))
        p4 = c16(s16(p3))
        p5 = sppf(c32(s32(p4)))
        n4 = up4(torch.cat([_upsample2(p5), p4], 1))
        n3 = up3(torch.cat([_upsample2(n4), p3], 1))
        m4 = pan4(torch.cat([down4(n3), n4], 1))
        m5 = pan5(torch.cat([down5(m4), p5], 1))
        return n3, m4, m5  # strides 8, 16, 32


class DetectHead(_Compact):
    def __init__(self, channels, num_classes: int = 80, reg_max: int = 16):
        super().__init__()
        # branch widths follow ultralytics v8 Detect: from the FIRST
        # level's channels, shared across levels
        ch0 = channels[0]
        c2 = max(16, ch0 // 4, 4 * reg_max)
        c3 = max(ch0, min(num_classes, 100))
        for c in channels:
            for m in (ConvBnAct(c, c2, 3), ConvBnAct(c2, c2, 3), Conv(c2, 4 * reg_max, 1, bias=True),
                      ConvBnAct(c, c3, 3), ConvBnAct(c3, c3, 3), Conv(c3, num_classes, 1, bias=True)):
                self.sub(m)

    def forward(self, feats):
        layers = list(self.children())
        outs = []
        for i, f in enumerate(feats):
            b1, b2, b3, c1, c2, c3 = layers[6 * i: 6 * i + 6]
            outs.append((b3(b2(b1(f))), c3(c2(c1(f)))))
        return outs


@contextlib.contextmanager
def _cudnn_without_tf32():
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def fp32_convolutions(dtype: torch.dtype, device: torch.device):
    """A context that keeps cuDNN's float32 convolutions in float32 (TF32
    off) for a `dtype` model on `device`; a no-op for bf16 or the CPU."""
    if torch.device(device).type == "cuda" and dtype == torch.float32:
        return _cudnn_without_tf32()
    return contextlib.nullcontext()


class Yolo(_Compact):
    """The detector; forward((B, 3, S, S) float) -> per level (box_dfl
    (B, 4 reg_max, h, w), cls_logits (B, num_classes, h, w)) in `dtype`.
    The convolutions' kernels and biases are held in `param_dtype`
    (default `dtype`: rounded once when loaded, where flax rounds them at
    every call; float32 for a model to train), batch norm's parameters and
    statistics in float32. A new model is in eval mode, as flax's apply
    defaults to train=False; the train steps switch it to train mode."""

    def __init__(self, num_classes: int = 80, width: float = 0.5, depth: float = 0.33,
                 reg_max: int = 16, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        backbone = YoloBackboneNeck(width, depth)
        self.sub(backbone)
        self.sub(DetectHead(backbone.channels, num_classes, reg_max))
        for m in self.modules():
            if isinstance(m, Conv):
                m.to(param_dtype or dtype)
        self.eval()

    def forward(self, x):
        backbone, head = self.children()
        x = x.to(self.dtype)
        with fp32_convolutions(self.dtype, x.device):
            return head(backbone(x))


def make_model(cfg: DetectorConfig, dtype: torch.dtype = torch.bfloat16,
               param_dtype: torch.dtype | None = None) -> Yolo:
    """The detector of `cfg` with uninitialised kernels (see init_model)."""
    return Yolo(cfg.num_classes, cfg.width_mult, cfg.depth_mult, dtype=dtype,
                param_dtype=param_dtype)


def init_model(cfg: DetectorConfig, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
               param_dtype: torch.dtype | None = None) -> Yolo:
    """The detector with the JAX package's random weights,
    `yolo.init_params(cfg, jax.random.key(seed))`, on the CPU: each
    kernel drawn by models/flax_init.py in flax's (kh, kw, in, out) layout
    from the key of its module path, then transposed. Move it with
    .to(device)."""
    return _draw_kernels(make_model(cfg, dtype, param_dtype), flax_init.key(seed))


def _draw_kernels(model: Yolo, root: np.ndarray) -> Yolo:
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, Conv):
                cout, cin, k, _ = mod.kernel.shape
                w = flax_init.lecun_normal(flax_init.fold_in_path(root, name.split(".") + [1]),
                                           (k, k, cin, cout))
                mod.kernel.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    return model


def init_params(cfg: DetectorConfig, key=None):
    """The JAX package's init_params: -> (model, variables). `key` is a
    seed, a raw key (the two uint32 words of jax.random.key_data) or None
    for key 0. `model` holds the draws in float32 and computes in bf16, as
    the flax model does; `variables` is flax's tree ({"params": ...,
    "batch_stats": ...}) of numpy arrays in flax's layout."""
    from aria_slam_tpu_torch.convert import yolo_to_flax

    if key is None or isinstance(key, int):
        root = flax_init.key(key or 0)
    else:
        root = np.asarray(key, np.uint32).reshape(2)
    model = _draw_kernels(make_model(cfg, torch.bfloat16, torch.float32), root)
    variables: dict = {}
    for path, v in yolo_to_flax(model).items():
        *parents, leaf = path.split("/")
        node = variables
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return model, variables


def decode_predictions(outs, input_size: int, num_classes: int, reg_max: int = 16):
    """Per-level DFL box decode -> ((B, A, 4) xyxy in input px, (B, A, C)
    scores), anchors row-major per level, levels in order."""
    boxes_all, scores_all = [], []
    for box, cls in outs:
        b, _, h, w = box.shape
        dev = box.device
        stride = input_size // h
        bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
        dfl = box.float().reshape(b, 4, reg_max, h, w)
        dist = torch.sum(torch.softmax(dfl, 2) * bins[:, None, None], 2)  # (B, 4, h, w) l,t,r,b
        cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * stride
        cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * stride
        gy, gx = torch.meshgrid(cy, cx, indexing="ij")
        xyxy = torch.stack([gx - dist[:, 0] * stride, gy - dist[:, 1] * stride,
                            gx + dist[:, 2] * stride, gy + dist[:, 3] * stride], -1)
        boxes_all.append(xyxy.reshape(b, h * w, 4))
        scores_all.append(torch.sigmoid(cls.float()).permute(0, 2, 3, 1).reshape(
            b, h * w, num_classes))
    return torch.cat(boxes_all, 1), torch.cat(scores_all, 1)


def load_weights(path: str, cfg: DetectorConfig, dtype: torch.dtype = torch.bfloat16) -> Yolo:
    """The detector of `cfg` with the weights of an `.npz` in the JAX
    package's format (flat "/"-joined flax variable paths, `params/...`
    and `batch_stats/...`, as its yolo.save_weights writes), on the CPU."""
    from aria_slam_tpu_torch.convert import yolo_from_flax

    with np.load(path, allow_pickle=False) as f:
        return yolo_from_flax(dict(f), make_model(cfg, dtype))


def save_weights(model: Yolo, path: str) -> None:
    """Write `model`'s weights as the JAX package's `.npz` (readable by its
    yolo.load_weights and by load_weights here), in float32: a bfloat16
    model's kernels as it holds them."""
    from aria_slam_tpu_torch.convert import yolo_to_flax

    np.savez(path, **yolo_to_flax(model))
