"""The multi-device dry run (counterpart of the JAX package's
`__graft_entry__._dryrun_impl`): every collective path of the port on one
mesh, at toy sizes.

On n ranks the mesh is (n / 2, 2) when n is even, else (n, 1), as the
reference lays it out. Each rank runs, in order:

1. the detector's data-parallel train step (parallel/multiseq.
   make_sharded_train_step: batch norm's statistics and the gradients
   summed over the data group) on a batch of 2 zero images a data rank at
   64 px, width 0.25, with SGD(LR) and zero targets shaped like the box
   maps;
2. the loop-closure DB query split over the model axis
   (parallel/sharded_db.sharded_topk_scores) against 8 keyframes a model
   rank of F = 64 random descriptors;
3. the batched pair front end split over the data axis (parallel/
   multiseq.shard_batched_frontend) on one pair of random 96 x 96 frames
   a data rank, 128 features on 2 levels, 32 hypotheses;
4. the multi-sequence chunk front end (eval/multi_eval.
   make_multi_chunk_frontend) on one sequence of 4 such frames a data
   rank, each rank running its block and the results gathered over the
   data axis.

On the CPU: `run(n, "gloo")` spawns n gloo ranks (parallel/mesh.spawn).
On the card: `run(1, "nccl")` runs in this process on the one-card NCCL
mesh (mesh.single_process_group), and `run(n, "nccl")` spawns n ranks,
one a card. `python -m aria_slam_tpu_torch.parallel.dryrun --devices 4
--cpu` runs the CPU form.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from aria_slam_tpu_torch.config import (
    CameraConfig, DetectorConfig, OrbConfig, PipelineConfig, RansacConfig,
)
from aria_slam_tpu_torch.eval import multi_eval
from aria_slam_tpu_torch.models import yolo
from aria_slam_tpu_torch.ops import epipolar
from aria_slam_tpu_torch.parallel import mesh as mesh_lib, multiseq, sharded_db

DETECTOR = DetectorConfig(input_size=64, width_mult=0.25, depth_mult=0.33)
FRONTEND = PipelineConfig(
    camera=CameraConfig(width=96, height=96, fx=80.0, fy=80.0, cx=48.0, cy=48.0),
    orb=OrbConfig(num_features=128, num_levels=2),
    ransac=RansacConfig(num_hypotheses=32))
DB_FEATURES = 64
LR = 1e-3              # the train step's SGD, the reference's optax.sgd(1e-3)
RANKS_TIMEOUT_S = 300.0  # the spawned ranks of run(), every part together


def mesh_shape(n: int) -> tuple:
    """(n_data, n_model): two model ranks when n is even, as the reference."""
    n_model = 2 if n % 2 == 0 and n >= 2 else 1
    return n // n_model, n_model


def box_targets(model: yolo.Yolo, batch: int, device) -> list:
    """Zero float32 targets shaped like the model's box maps for `batch`
    images."""
    with torch.no_grad():
        outs = model.eval()(torch.zeros(1, 3, DETECTOR.input_size, DETECTOR.input_size,
                                        device=device))
    return [torch.zeros((batch,) + box.shape[1:], device=device) for box, _ in outs]


def train_step_rank(rank: int, images, targets) -> dict:
    """One rank of a spawned group: make_sharded_train_step on the whole
    group as the data axis, from init_model(DETECTOR, 0) in float32, one
    SGD(LR) step on the whole batch (numpy images (B, 3, S, S) and
    targets, B a multiple of the group). Returns the loss and the model's
    state_dict as numpy."""
    mesh = mesh_lib.make_mesh(n_model=1)
    model = yolo.init_model(DETECTOR, 0, dtype=torch.float32, param_dtype=torch.float32)
    step = multiseq.make_sharded_train_step(mesh, model, torch.optim.SGD(model.parameters(),
                                                                         lr=LR))
    loss = step(torch.from_numpy(images), [torch.from_numpy(t) for t in targets])
    return {"loss": float(loss),
            "state": {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}}


def run_rank(rank: int) -> dict:
    """The dry run on the initialised default group (module docstring);
    returns what each part produced, as host values."""
    n_data, n_model = mesh_shape(dist.get_world_size())
    mesh = mesh_lib.make_mesh(n_data, n_model)
    dev = mesh.device
    out = {"mesh": (n_data, n_model)}

    # 1. the data-parallel train step
    model = yolo.init_model(DETECTOR, 0, param_dtype=torch.float32).to(dev)
    batch = 2 * n_data
    images = torch.zeros(batch, 3, DETECTOR.input_size, DETECTOR.input_size, device=dev)
    targets = box_targets(model, batch, dev)
    step = multiseq.make_sharded_train_step(mesh, model, torch.optim.SGD(model.parameters(),
                                                                         lr=LR))
    out["loss"] = float(step(images, targets))

    # 2. the model-sharded DB query
    rng = np.random.default_rng(1)
    n_db = 8 * n_model
    q = torch.from_numpy(rng.integers(0, 2, (DB_FEATURES, 256)).astype(np.int8)).to(dev)
    db = torch.from_numpy(rng.integers(0, 2, (n_db, DB_FEATURES, 256)).astype(np.int8)).to(dev)
    vals, idx = sharded_db.sharded_topk_scores(
        mesh, q, torch.ones(DB_FEATURES, dtype=torch.bool, device=dev), db,
        torch.ones(n_db, DB_FEATURES, dtype=torch.bool, device=dev), top_k=3)
    out["db_top"] = idx.tolist()
    out["db_scores"] = vals.tolist()

    # 3. the data-parallel pair front end
    img1 = torch.from_numpy(rng.uniform(0, 255, (n_data, 96, 96)).astype(np.float32)).to(dev)
    img2 = torch.from_numpy(rng.uniform(0, 255, (n_data, 96, 96)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2 + mesh.index["data"])
    R, t, ninl = multiseq.shard_batched_frontend(mesh, FRONTEND)(img1, img2,
                                                                 epipolar.TorchSampler(gen))
    out["pairs_R"] = R.cpu().numpy()

    # 4. the multi-sequence chunk front end over the data axis
    frames = torch.from_numpy(rng.uniform(0, 255, (n_data, 4, 96, 96)).astype(np.uint8))
    local = mesh_lib.shard_rows(mesh, frames, "data").to(dev)
    gyro_R = torch.eye(3, device=dev).expand(len(local), 3, 3, 3)
    gyro_ok = torch.zeros(len(local), 3, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3 + mesh.index["data"])
    res = multi_eval.make_multi_chunk_frontend(FRONTEND)(
        local, epipolar.TorchSampler(gen), gyro_R, gyro_ok)
    out["chunk_R"] = mesh_lib.gather_rows(mesh, res[:1], "data")[0].cpu().numpy()
    return out


def run(n_devices: int, backend: str = "gloo") -> list:
    """The dry run on n_devices ranks: gloo ranks on the CPU, or NCCL ranks
    on the cards (one card runs in this process). Returns every rank's
    result."""
    if backend == "nccl" and n_devices == 1:
        with mesh_lib.single_process_group("nccl"):
            return [run_rank(0)]
    return mesh_lib.spawn(run_rank, n_devices, backend, timeout_s=RANKS_TIMEOUT_S)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the multi-device dry run")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to run on the CPU")
    for rank, res in enumerate(run(args.devices, "gloo" if args.cpu else "nccl")):
        print(f"rank {rank}: mesh {res['mesh']}, loss {res['loss']:.6f}, db top "
              f"{res['db_top']}, pairs {res['pairs_R'].shape}, chunk {res['chunk_R'].shape}",
              flush=True)


if __name__ == "__main__":
    main()
