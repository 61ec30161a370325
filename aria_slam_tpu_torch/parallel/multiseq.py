"""Data-parallel batch execution (counterpart of the JAX package's
parallel/multiseq.py): B pairs of frames through ORB, the matcher and
RANSAC in one batched pass, the same split over the mesh's "data" ranks,
and the detector's training step, alone and data-parallel.

The reference jits its train step with the batch sharded over "data" and
the parameters replicated, so XLA computes the function of the whole
global batch: batch norm's statistics are the global batch's and the
gradients are summed over the ranks. The data-parallel step here computes
that same function: batch norm sums its per-channel statistics over the
data group (models/yolo.BatchNorm.stats_group, with the gradient summed
back through the reduction), and the step averages the gradients and the
loss over the group before the optimiser's update (each rank's loss is a
mean over an equal block of the batch).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.models import yolo
from aria_slam_tpu_torch.ops import epipolar, match as match_ops, orb
from aria_slam_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows


def batched_frontend(cfg: PipelineConfig):
    """run(img1s, img2s, sampler) -> (R (B, 3, 3), t (B, 3), num_inliers
    (B,)) for (B, H, W) frames (uint8 or float, cast on the device): both
    sides' ORB in one call each, one batched match and one RANSAC call
    for all B pairs. sampler: the RANSAC draws (ops/epipolar.py)."""
    def run(img1s, img2s, sampler):
        dev = img1s.device
        K = torch.as_tensor(cfg.camera.K, device=dev)
        f1 = orb.extract_batch(img1s.to(torch.float32), cfg.orb)
        f2 = orb.extract_batch(img2s.to(torch.float32), cfg.orb)
        m = match_ops.match_batched(f2, f1, cfg.matcher.ratio)
        tidx = m.train_idx.long()
        xy_prev = torch.take_along_dim(f1.xy, tidx[..., None], 1)
        valid = m.valid & torch.take_along_dim(f1.valid, tidx, 1)
        delta = epipolar.estimate_relative_pose(xy_prev, f2.xy, valid, K, cfg.ransac, sampler)
        return delta.R, delta.t, delta.num_inliers

    return run


def shard_batched_frontend(mesh: Mesh, cfg: PipelineConfig):
    """run(img1s, img2s, sampler) over the whole batch on every data
    rank: each rank runs its contiguous block of the B pairs (B a multiple
    of the data axis) and the results are gathered over the data axis, so
    every rank returns all B rows, in order. Collective over the data
    group."""
    fn = batched_frontend(cfg)

    def run(img1s, img2s, sampler):
        outs = fn(shard_rows(mesh, img1s, "data"), shard_rows(mesh, img2s, "data"), sampler)
        return gather_rows(mesh, outs, "data")

    return run


# --------------------------------------------------------- detector training
def stand_in_loss(outs, targets):
    """The dry run's L2 stand-in for the detection loss (detection losses
    need labels): each level's box map against its target, plus 1e-3 of
    the class logits' mean square, in float32."""
    return (sum(torch.mean((b.float() - t) ** 2) for (b, _), t in zip(outs, targets))
            + sum(torch.mean(c.float() ** 2) * 1e-3 for _, c in outs))


def _train_step(model, optimizer, device, group, n_data: int):
    def step(images, targets):
        model.train()
        images = torch.as_tensor(images, device=device)
        targets = [torch.as_tensor(t, device=device) for t in targets]
        optimizer.zero_grad(set_to_none=True)
        with yolo.fp32_convolutions(model.dtype, device):
            loss = stand_in_loss(model(images), targets)
            loss.backward()
        loss = loss.detach()
        if group is not None:
            # one all-reduce for every gradient and the loss
            grads = [p.grad for p in model.parameters()]
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
            dist.all_reduce(flat, group=group)
            flat /= n_data
            for g, part in zip(grads, torch.split(flat[:-1], [g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            loss = flat[-1]
        optimizer.step()
        return loss

    return step


def detector_train_step(model: yolo.Yolo, optimizer, device=None):
    """step(images (B, 3, S, S), targets) -> loss: one step of the
    detector `model` (moved to `device`, CUDA unless asked otherwise) on
    stand_in_loss through the forward pass in train mode, the backward pass
    and `optimizer`; targets are float32 maps shaped like the model's box
    outputs (B, 4 reg_max, h, w), one a level. The model's batch-norm
    statistics are updated in place."""
    from aria_slam_tpu_torch.pipeline.slam_pipeline import resolve_device

    device = resolve_device(device)
    model.to(device)
    return _train_step(model, optimizer, device, None, 1)


def make_sharded_train_step(mesh: Mesh, model: yolo.Yolo, optimizer):
    """detector_train_step over the mesh's data axis: step(images,
    targets) takes the whole batch on every rank (B a multiple of the data
    axis), runs this rank's contiguous block of it and returns the whole
    batch's loss; batch norm's statistics and the gradients are the whole
    batch's (module docstring), so every rank keeps the same parameters.
    Collective over the data group; the model runs on mesh.device."""
    model.to(mesh.device)
    for m in model.modules():
        if isinstance(m, yolo.BatchNorm):
            m.stats_group = mesh.data_group
    inner = _train_step(model, optimizer, mesh.device, mesh.data_group, mesh.shape["data"])

    def step(images, targets):
        return inner(shard_rows(mesh, images, "data"),
                     [shard_rows(mesh, t, "data") for t in targets])

    return step
