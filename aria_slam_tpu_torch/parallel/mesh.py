"""The device mesh over torch.distributed (counterpart of the JAX
package's parallel/mesh.py).

Two axes, as in the reference:
  - "data": many sequences (or frame pairs) evaluated side by side, each
    rank on its own contiguous block (eval/multi_eval.py,
    parallel/multiseq.py);
  - "model": the loop-closure keyframe DB split across ranks, each scoring
    its own block of keyframes (parallel/sharded_db.py).
The mesh is the process group, one rank a device, laid out row-major as
(data, model): rank = data_index * n_model + model_index, as JAX's
`reshape(n_data, n_model)` of the device list. Each rank holds one group
for the ranks of its data row (`model_group`) and one for the ranks of
its model column (`data_group`).

`spawn` starts the ranks of a group as child processes and rendezvouses
them through a FileStore in a temporary directory: no TCP port, so no
network and no race for ports between concurrent runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    rank: int
    shape: dict                 # {"data": n_data, "model": n_model}
    data_group: object          # the ranks of this rank's model column
    model_group: object         # the ranks of this rank's data row
    device: torch.device

    @property
    def index(self) -> dict:
        """This rank's position on each axis."""
        return {"data": self.rank // self.shape["model"],
                "model": self.rank % self.shape["model"]}


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over the initialised default group,
    whose size must be n_data * n_model (n_data defaults to world //
    n_model). Collective: every rank calls it, and every rank creates
    every subgroup in the same order, as dist.new_group requires. The
    device is cuda:<local rank> under NCCL and the CPU under gloo."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, the group "
                         f"has {world}")
    data_group = model_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    if dist.get_backend() == "gloo":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(rank=rank, shape={"data": n_data, "model": n_model}, data_group=data_group,
                model_group=model_group, device=device)


def shard_rows(mesh: Mesh, x, axis: str):
    """This rank's contiguous block of x's leading axis split over `axis`
    ("data" or "model"): what P(axis) means for a JAX array. The length
    must be a multiple of the axis size."""
    n = mesh.shape[axis]
    if len(x) % n:
        raise ValueError(f"a leading axis of {len(x)} does not split over the {n} ranks of "
                         f"the {axis!r} axis")
    block = len(x) // n
    i = mesh.index[axis]
    return x[i * block:(i + 1) * block]


def gather_rows(mesh: Mesh, xs, axis: str) -> tuple:
    """The inverse of shard_rows for each tensor of xs: every rank's block
    gathered over `axis` in rank order (collective over that axis's group;
    the blocks as they are when the axis has one rank)."""
    n = mesh.shape[axis]
    if n == 1:
        return tuple(xs)
    group = mesh.data_group if axis == "data" else mesh.model_group
    out = []
    for x in xs:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        out.append(torch.cat(parts))
    return tuple(out)


@contextlib.contextmanager
def single_process_group(backend: str = "nccl"):
    """A world-size-1 default group in this process (rendezvous through a
    FileStore in a temporary directory), destroyed on exit: the mesh of
    one card. A second group in the same process must wait for the exit."""
    tmp = tempfile.mkdtemp(prefix="aria_mesh_")
    try:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _child(rank: int, world_size: int, backend: str, store_path: str, fn, args, results):
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_jobs(rank: int, jobs) -> list:
    """Several rank functions one after the other on one spawned group:
    jobs [(fn, args), ...] -> [fn(rank, *args), ...]. Pays the group's
    start once: spawn(run_jobs, n, args=(jobs,))."""
    return [fn(rank, *args) for fn, args in jobs]


def spawn(fn, world_size: int, backend: str = "gloo", args: tuple = (),
          timeout_s: float = 120.0) -> list:
    """Run fn(rank, *args) in `world_size` new processes joined in one
    process group (`backend` "gloo" or "nccl") and return their results
    in rank order. fn and args must pickle by reference to importable
    code. A child that raises fails the call with its traceback; a call
    that outlasts timeout_s ends every child and raises TimeoutError."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="aria_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world_size, backend, os.path.join(tmp, "store"), fn, args,
                               results))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got = {}
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"mesh rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} mesh ranks did not finish in "
                                       f"{timeout_s} s; done: {sorted(got)}")
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} raised:\n{out}")
            got[rank] = out
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
