"""Offline weight conversion: ultralytics YOLOv8 checkpoint -> the port's
`Yolo` and the JAX package's npz (counterpart of the JAX package's
models/convert_weights.py).

Parity: the reference converts public checkpoints offline into its
inference format (scripts/generate_engine.sh:34-101: ultralytics .pt ->
ONNX -> trtexec .engine). Here the target is models/yolo.Yolo, and the
file the detector reads, the JAX package's npz (yolo.save_weights: flat
"/"-joined flax variable paths), which models/detect.make_detector(
weights_path=...) of either package loads.

Input: a torch state_dict in ultralytics DetectionModel naming
("model.0.conv.weight", ...). Obtain one offline with:

    from ultralytics import YOLO
    import torch
    torch.save(YOLO("yolov8s.pt").model.state_dict(), "yolov8s_sd.pt")

then convert (no ultralytics needed):

    python -m aria_slam_tpu_torch.models.convert_weights yolov8s_sd.pt \\
        yolov8s.npz --width 0.5 --depth 0.33 --classes 80

The mapping is structural: models/yolo.py mirrors ultralytics v8 layer
for layer (explicit k//2 padding, BN eps 1e-3, Detect branch widths from
the first level), and its state_dict keys are the flax variable paths
with "." for "/". The mapping names flax paths, as the reference's does;
convert.yolo_from_flax then moves conv kernels from flax's (kh, kw, in,
out) to the port's (out, in, kh, kw). The fixed-weight DFL conv
(model.22.dfl) is skipped: decode_predictions computes the same softmax
expectation directly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from aria_slam_tpu_torch.config import DetectorConfig


def _n(d: int, mult: float) -> int:
    return max(1, int(round(d * mult)))


def _conv(u: str, f: Tuple[str, ...]) -> List[tuple]:
    """Entries for one ultralytics Conv (conv + bn) mapped to ConvBnAct."""
    return [
        (f"{u}.conv.weight", ("params",) + f + ("Conv_0", "kernel"), "conv"),
        (f"{u}.bn.weight", ("params",) + f + ("BatchNorm_0", "scale"), "raw"),
        (f"{u}.bn.bias", ("params",) + f + ("BatchNorm_0", "bias"), "raw"),
        (f"{u}.bn.running_mean", ("batch_stats",) + f + ("BatchNorm_0", "mean"), "raw"),
        (f"{u}.bn.running_var", ("batch_stats",) + f + ("BatchNorm_0", "var"), "raw"),
    ]


def _c2f(u: str, f: Tuple[str, ...], n: int) -> List[tuple]:
    out = _conv(f"{u}.cv1", f + ("ConvBnAct_0",))
    for i in range(n):
        out += _conv(f"{u}.m.{i}.cv1", f + (f"Bottleneck_{i}", "ConvBnAct_0"))
        out += _conv(f"{u}.m.{i}.cv2", f + (f"Bottleneck_{i}", "ConvBnAct_1"))
    out += _conv(f"{u}.cv2", f + ("ConvBnAct_1",))
    return out


def build_mapping(depth_mult: float) -> List[tuple]:
    """Ordered (ultralytics key, flax path, transform) triples for the
    full v8 detection model. Structure is fixed; only C2f repeat counts
    depend on the depth multiplier."""
    bb = ("YoloBackboneNeck_0",)
    n3 = _n(3, depth_mult)
    n6 = _n(6, depth_mult)
    m: List[tuple] = []
    m += _conv("model.0", bb + ("ConvBnAct_0",))                 # stem /2
    m += _conv("model.1", bb + ("ConvBnAct_1",))                 # /4
    m += _c2f("model.2", bb + ("C2f_0",), n3)
    m += _conv("model.3", bb + ("ConvBnAct_2",))                 # /8
    m += _c2f("model.4", bb + ("C2f_1",), n6)
    m += _conv("model.5", bb + ("ConvBnAct_3",))                 # /16
    m += _c2f("model.6", bb + ("C2f_2",), n6)
    m += _conv("model.7", bb + ("ConvBnAct_4",))                 # /32
    m += _c2f("model.8", bb + ("C2f_3",), n3)
    m += _conv("model.9.cv1", bb + ("SPPF_0", "ConvBnAct_0"))
    m += _conv("model.9.cv2", bb + ("SPPF_0", "ConvBnAct_1"))
    # PAN neck (layers 10/13 are upsample, 11/14/17/20 are concat)
    m += _c2f("model.12", bb + ("C2f_4",), n3)                   # n4
    m += _c2f("model.15", bb + ("C2f_5",), n3)                   # n3
    m += _conv("model.16", bb + ("ConvBnAct_5",))                # d4
    m += _c2f("model.18", bb + ("C2f_6",), n3)                   # m4
    m += _conv("model.19", bb + ("ConvBnAct_6",))                # d5
    m += _c2f("model.21", bb + ("C2f_7",), n3)                   # m5
    # Detect head: cv2 = box branch, cv3 = cls branch, per level l
    hd = ("DetectHead_0",)
    for lvl in range(3):
        m += _conv(f"model.22.cv2.{lvl}.0", hd + (f"ConvBnAct_{4 * lvl}",))
        m += _conv(f"model.22.cv2.{lvl}.1", hd + (f"ConvBnAct_{4 * lvl + 1}",))
        m += [
            (f"model.22.cv2.{lvl}.2.weight",
             ("params",) + hd + (f"Conv_{2 * lvl}", "kernel"), "conv"),
            (f"model.22.cv2.{lvl}.2.bias",
             ("params",) + hd + (f"Conv_{2 * lvl}", "bias"), "raw"),
        ]
        m += _conv(f"model.22.cv3.{lvl}.0", hd + (f"ConvBnAct_{4 * lvl + 2}",))
        m += _conv(f"model.22.cv3.{lvl}.1", hd + (f"ConvBnAct_{4 * lvl + 3}",))
        m += [
            (f"model.22.cv3.{lvl}.2.weight",
             ("params",) + hd + (f"Conv_{2 * lvl + 1}", "kernel"), "conv"),
            (f"model.22.cv3.{lvl}.2.bias",
             ("params",) + hd + (f"Conv_{2 * lvl + 1}", "bias"), "raw"),
        ]
    return m


# keys legitimately absent from the model
_SKIP_PREFIXES = ("model.22.dfl",)
_SKIP_SUFFIXES = ("num_batches_tracked",)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: DetectorConfig):
    """ultralytics state_dict (numpy arrays or torch tensors) -> the port's
    `Yolo` computing in bf16, on the CPU, its kernels held in float32
    (rounded at each call, as flax rounds float32 variables). Names and
    shapes are checked against the model of `cfg`. Raises KeyError on a
    missing key, ValueError on a shape mismatch, unconsumed checkpoint
    weights or model variables no key covers."""
    from aria_slam_tpu_torch.convert import yolo_from_flax, yolo_to_flax
    from aria_slam_tpu_torch.models import yolo

    def to_np(v):
        return v.detach().float().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    model = yolo.make_model(cfg, param_dtype=torch.float32)
    ref = {k: v.shape for k, v in yolo_to_flax(model).items()}

    out = {}
    consumed = set()
    for ukey, fpath, tf in build_mapping(cfg.depth_mult):
        path = "/".join(fpath)
        if ukey not in sd:
            raise KeyError(f"checkpoint missing {ukey} (for {path})")
        v = to_np(sd[ukey]).astype(np.float32)
        if tf == "conv":
            v = v.transpose(2, 3, 1, 0)  # (out,in,kh,kw) -> (kh,kw,in,out)
        if path not in ref:
            raise KeyError(f"model missing {path}")
        want = ref[path]
        if tuple(v.shape) != tuple(want):
            raise ValueError(
                f"shape mismatch at {ukey} -> {path}: "
                f"checkpoint {v.shape} vs model {want} -- wrong width/depth/"
                f"classes for this checkpoint?"
            )
        out[path] = v
        consumed.add(ukey)

    leftovers = [
        k for k in sd
        if k not in consumed
        and not k.startswith(_SKIP_PREFIXES)
        and not k.endswith(_SKIP_SUFFIXES)
    ]
    if leftovers:
        raise ValueError(f"unconsumed checkpoint keys: {leftovers[:8]}"
                         f"{'...' if len(leftovers) > 8 else ''}")
    missing = [p for p in ref if p not in out]
    if missing:
        raise ValueError(f"model variables not covered: {missing[:8]}")
    return yolo_from_flax(out, model)


def ultralytics_state_dict(model, cfg: DetectorConfig) -> Dict[str, torch.Tensor]:
    """The inverse of convert_state_dict: `model`'s weights under the
    ultralytics names of build_mapping, float32 on the CPU, conv kernels
    as (out, in, kh, kw)."""
    from aria_slam_tpu_torch.convert import yolo_to_flax

    flat = yolo_to_flax(model)
    return {ukey: torch.from_numpy(np.ascontiguousarray(
        flat["/".join(fpath)].transpose(3, 2, 0, 1) if tf == "conv" else flat["/".join(fpath)]))
        for ukey, fpath, tf in build_mapping(cfg.depth_mult)}


def load_checkpoint(pt_path: str) -> dict:
    """The state_dict of a .pt file: a full ultralytics checkpoint
    ({"model": module, ...}), a raw state_dict, or a module."""
    obj = torch.load(pt_path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        return obj["model"].state_dict()  # full ultralytics checkpoint
    if isinstance(obj, dict):
        return obj  # raw state_dict
    return obj.state_dict()


def convert_file(pt_path: str, out_npz: str, cfg: DetectorConfig) -> None:
    """Convert a .pt checkpoint into the JAX package's npz (float32)."""
    from aria_slam_tpu_torch.models import yolo

    yolo.save_weights(convert_state_dict(load_checkpoint(pt_path), cfg), out_npz)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pt_path", help=".pt state_dict (ultralytics naming)")
    ap.add_argument("out_npz", help="output .npz for detect.make_detector")
    ap.add_argument("--width", type=float, default=0.5, help="s=0.5 n=0.25")
    ap.add_argument("--depth", type=float, default=0.33)
    ap.add_argument("--classes", type=int, default=80)
    args = ap.parse_args(argv)
    cfg = DetectorConfig(width_mult=args.width, depth_mult=args.depth,
                         num_classes=args.classes)
    convert_file(args.pt_path, args.out_npz, cfg)
    print(f"wrote {args.out_npz}")


if __name__ == "__main__":
    main()
