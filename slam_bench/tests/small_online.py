"""The online cell at a small size for runs on the CPU (the tests' only
use): half the camera's size, 300 features on 3 levels, the detector at
a 64 px input, small capacities, and a circuit of 24 frames (2.4 s at
10 fps) whose loops the gap of 20 frames lets close; the first frames
and loops of the window sampled."""

import copy

from slam_bench.harness import core

CELL = "online_nav.circuit_moving"
SEED = 123456789012


def overrides(root: str = core.ROOT) -> dict:
    c = core.find_cell(CELL, root)
    p = copy.deepcopy(c.config["pipeline"])
    p["camera"].update(width=376, height=240, fx=229.3, fy=228.6, cx=183.6, cy=124.2)
    p["orb"].update(num_features=300, num_levels=3)
    p["ransac"].update(num_hypotheses=32, h_hypotheses=16)
    p["detector"].update(input_size=64)
    p["mapper"].update(max_points=5000)
    p["loop"].update(max_keyframes=32, min_frames_between=20)
    p["pose_graph"].update(max_nodes=128, max_edges=256, cg_iterations=24)
    tr = {"period": 2.4, "render_frames": 72, "imu_seconds": 7.2, "setup_max_frame": 60,
          "session_nodes": 120, "sample_span": 4, "sample_loops": 2,
          "loop_span": 2, "nms_boxes": 120}
    # RANSAC with 32 hypotheses over 300 features flips success in a few
    # per cent of pairs between the program and the reference (small.py);
    # of three sampled frames one flip is a share of 0.33
    limits = {"pose_ok_flip": {"max": 0.34}}
    return {"config": {"pipeline": p}, "traffic": tr, "limits": limits}


def run(seconds: float = 20.0, trace: bool = False, root: str = core.ROOT, seed: int = SEED):
    return core.run_cell(CELL, seed, seconds, trace, device="cpu", root=root,
                         overrides=overrides(root))


def run_frames(frames: int = 8, root: str = core.ROOT, seed: int = SEED):
    """The cell's driver set up and stepped through a fixed number of
    window frames, then checked -> (checks [(name, value, limit, ok)],
    numbers). A timed window on a loaded CPU may hold a frame or two;
    this holds the same frames however busy the machine is."""
    import torch

    from slam_bench.harness import trace

    cell = core.find_cell(CELL, root)
    for key, val in overrides(root).items():
        getattr(cell, key).update(val)
    run = core.Run(cell, seed, 0.0, False, torch.device("cpu"), spans=trace.Spans())
    driver = core.load_module("drivers", cell.traffic["driver"], root).Driver(run)
    driver.setup()
    for _ in range(frames):
        driver.step()
    numbers = driver.check()
    return core.check_limits(numbers, cell.limits), numbers
