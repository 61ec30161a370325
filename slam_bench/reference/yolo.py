"""Plain YOLO-s detector (a YOLOv8-style anchor-free model: CSP backbone of
C2f blocks, SPPF, a PAN-FPN neck, a decoupled head with distribution-focal
box regression, as the JAX package defines it), as functions over a dict
of named float32 tensors in float32 with TF32 off. `params` lists every
tensor's name and shape in the naming the program's state dict uses, so
one set of weights drawn by the benchmark serves both sides. `quant`
rounds each convolution's operands (the control runs it at fp8). Torch
only; imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ch(c, w):
    return max(16, int(round(c * w / 8)) * 8)


def _n(d, m):
    return max(1, int(round(d * m)))


class _Names:
    """Submodule names numbered per kind in creation order."""

    def __init__(self, prefix):
        self.prefix, self.counts = prefix, {}

    def __call__(self, kind):
        n = self.counts.get(kind, 0)
        self.counts[kind] = n + 1
        return f"{self.prefix}{kind}_{n}."


def _cba(spec, pre, cin, cout, k, s=1):
    spec.append(("cba", pre, cin, cout, k, s))


def _c2f(spec, pre, cin, cout, n, shortcut=True):
    h = cout // 2
    nm = _Names(pre)
    first = nm("ConvBnAct")
    blocks = []
    for _ in range(n):
        b = nm("Bottleneck")
        bn = _Names(b)
        blocks.append((bn("ConvBnAct"), bn("ConvBnAct"), shortcut))
    last = nm("ConvBnAct")
    spec.append(("c2f", pre, cin, cout, h, first, blocks, last))


def architecture(width=0.5, depth=0.33, num_classes=80, reg_max=16):
    """The layer list: [(kind, name prefix, sizes...)], backbone and neck
    in the order the forward consumes them, then the head."""
    c1, c2, c3, c4, c5 = (_ch(c, width) for c in (64, 128, 256, 512, 1024))
    n3, n6 = _n(3, depth), _n(6, depth)
    bb = []
    nm = _Names("YoloBackboneNeck_0.")
    for kind, args in (("cba", (3, c1, 3, 2)), ("cba", (c1, c2, 3, 2)), ("c2f", (c2, c2, n3)),
                       ("cba", (c2, c3, 3, 2)), ("c2f", (c3, c3, n6)),
                       ("cba", (c3, c4, 3, 2)), ("c2f", (c4, c4, n6)),
                       ("cba", (c4, c5, 3, 2)), ("c2f", (c5, c5, n3)), ("sppf", (c5, c5)),
                       ("c2f", (c5 + c4, c4, n3, False)), ("c2f", (c4 + c3, c3, n3, False)),
                       ("cba", (c3, c3, 3, 2)), ("c2f", (c3 + c4, c4, n3, False)),
                       ("cba", (c4, c4, 3, 2)), ("c2f", (c4 + c5, c5, n3, False))):
        if kind == "cba":
            _cba(bb, nm("ConvBnAct"), *args)
        elif kind == "c2f":
            _c2f(bb, nm("C2f"), *args)
        else:
            pre = nm("SPPF")
            sn = _Names(pre)
            bb.append(("sppf", pre, args[0], args[1], sn("ConvBnAct"), sn("ConvBnAct")))
    c2h = max(16, c3 // 4, 4 * reg_max)
    c3h = max(c3, min(num_classes, 100))
    head = []
    hn = _Names("DetectHead_0.")
    for c in (c3, c4, c5):
        head.append(((hn("ConvBnAct"), c, c2h), (hn("ConvBnAct"), c2h, c2h),
                     (hn("Conv"), c2h, 4 * reg_max),
                     (hn("ConvBnAct"), c, c3h), (hn("ConvBnAct"), c3h, c3h),
                     (hn("Conv"), c3h, num_classes)))
    return bb, head


def params(width=0.5, depth=0.33, num_classes=80, reg_max=16):
    """[(name, shape, kind)] of every tensor; kind is "kernel" (with its
    fan-in), "conv_bias", "bn_scale", "bn_bias", "bn_mean" or "bn_var"."""
    out = []

    def cba(pre, cin, cout, k):
        out.append((pre + "Conv_0.kernel", (cout, cin, k, k), "kernel"))
        for leaf, kind in (("scale", "bn_scale"), ("bias", "bn_bias"), ("mean", "bn_mean"),
                           ("var", "bn_var")):
            out.append((pre + "BatchNorm_0." + leaf, (cout,), kind))

    bb, head = architecture(width, depth, num_classes, reg_max)
    for layer in bb:
        if layer[0] == "cba":
            _, pre, cin, cout, k, _s = layer
            cba(pre, cin, cout, k)
        elif layer[0] == "c2f":
            _, pre, cin, cout, h, first, blocks, last = layer
            cba(first, cin, 2 * h, 1)
            for a, b, _sc in blocks:
                cba(a, h, h, 3)
                cba(b, h, h, 3)
            cba(last, (2 + len(blocks)) * h, cout, 1)
        else:
            _, pre, cin, cout, first, last = layer
            cba(first, cin, cout // 2, 1)
            cba(last, 4 * (cout // 2), cout, 1)
    for level in head:
        for (pre, cin, cout), k in zip(level, (3, 3, 1, 3, 3, 1)):
            if pre.split(".")[-2].startswith("Conv_"):
                out.append((pre + "kernel", (cout, cin, 1, 1), "kernel"))
                out.append((pre + "bias", (cout,), "conv_bias"))
            else:
                cba(pre, cin, cout, k)
    return out


def forward(W, x, width=0.5, depth=0.33, num_classes=80, reg_max=16, quant=None,
            conv_fn=None):
    """x (B, 3, S, S) float32 in [0, 1] -> per level (box (B, 4 reg_max,
    h, w), cls (B, classes, h, w)) float32. conv_fn(x, kernel, stride,
    pad) replaces the convolution (the operation count uses it)."""
    q = quant or (lambda t: t)
    cf = conv_fn or (lambda t, k, s, p: F.conv2d(t, k, stride=s, padding=p))

    def conv(pre, t, s, pad, bias=False):
        y = cf(q(t), q(W[pre + "kernel"]), s, pad)
        return y + W[pre + "bias"][:, None, None] if bias else y

    def cba(pre, t, k, s=1):
        y = conv(pre + "Conv_0.", t, s, k // 2)
        bn = pre + "BatchNorm_0."
        mul = torch.rsqrt(W[bn + "var"] + 1e-3) * W[bn + "scale"]
        return F.silu((y - W[bn + "mean"][:, None, None]) * mul[:, None, None]
                      + W[bn + "bias"][:, None, None])

    def run(layer, t):
        if layer[0] == "cba":
            return cba(layer[1], t, layer[4], layer[5])
        if layer[0] == "c2f":
            _, _, _, _, h, first, blocks, last = layer
            y = cba(first, t, 1)
            parts = [y[:, :h], y[:, h:]]
            for a, b, sc in blocks:
                z = cba(b, cba(a, parts[-1], 3), 3)
                parts.append(parts[-1] + z if sc else z)
            return cba(last, torch.cat(parts, 1), 1)
        _, _, _, _, first, last = layer
        y = cba(first, t, 1)
        p1 = F.max_pool2d(y, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return cba(last, torch.cat([y, p1, p2, p3], 1), 1)

    bb, head = architecture(width, depth, num_classes, reg_max)
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
    s2, s4, c4, s8, c8, s16, c16, s32, c32, sppf, up4, up3, d4, pan4, d5, pan5 = bb
    p3 = run(c8, run(s8, run(c4, run(s4, run(s2, x)))))
    p4 = run(c16, run(s16, p3))
    p5 = run(sppf, run(c32, run(s32, p4)))
    n4 = run(up4, torch.cat([up(p5), p4], 1))
    n3 = run(up3, torch.cat([up(n4), p3], 1))
    m4 = run(pan4, torch.cat([run(d4, n3), n4], 1))
    m5 = run(pan5, torch.cat([run(d5, m4), p5], 1))
    outs = []
    for feat, level in zip((n3, m4, m5), head):
        (b1, _, _), (b2, _, _), (b3, _, _), (k1, _, _), (k2, _, _), (k3, _, _) = level
        box = conv(b3, cba(b2, cba(b1, feat, 3), 3), 1, 0, bias=True)
        cls = conv(k3, cba(k2, cba(k1, feat, 3), 3), 1, 0, bias=True)
        outs.append((box, cls))
    return outs


def preprocess(frames, size):
    """(B, H, W) grey [0, 255] -> (B, 3, size, size) [0, 1]: the bilinear
    resize (half-pixel centres, edge clamped) as banded matrices on
    bf16-rounded operands, the reference's."""
    from slam_bench.reference.orb import bilinear_matrix, separable

    h, w = frames.shape[-2:]
    x = separable(frames.to(torch.float32), bilinear_matrix(size, h), bilinear_matrix(size, w))
    return (x / 255.0)[:, None].expand(-1, 3, size, size)
