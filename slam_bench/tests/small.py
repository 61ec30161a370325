"""Small sizes of the cells for runs on the CPU (the tests' only use):
the cells' own files with their widths cut, a few frames, a short
window."""

import copy

from slam_bench.harness import core

SEED = 123456789012


def overrides(cell: str, root: str = core.ROOT) -> dict:
    c = core.find_cell(cell, root)
    p = copy.deepcopy(c.config["pipeline"])
    p["camera"].update(width=376, height=240, fx=229.3, fy=228.6, cx=183.6, cy=124.2)
    p["orb"].update(num_features=300, num_levels=3)
    p["ransac"].update(num_hypotheses=32, h_hypotheses=16)
    p["detector"].update(input_size=64)
    p["mapper"].update(max_points=5000)
    p["loop"].update(max_keyframes=32, min_frames_between=4)
    cfg = {"pipeline": p, "chunk": 8}
    if c.traffic["driver"] == "chunked_stream":
        tr = {"frames": 17, "imu_seconds": 2.0}
    else:
        cfg["sequences"] = 2
        tr = {"cycle": 24, "imu_seconds": 4.0, "ate_frames": 9}
    over = {"config": cfg, "traffic": tr}
    # RANSAC with 32 hypotheses over 300 features flips success in 2-4 %
    # of pairs between the program and the reference (a broken solver,
    # 30-50 %); the cells' 256 over 2000, under 1 %
    over["limits"] = {"pose_ok_flip": {"max": 0.1}}
    if "loops_min" in c.limits:
        # a 17-frame sequence never revisits: the loop count is the card's
        over["limits"]["loops_min"] = {"min": 0}
    return over


def run(cell: str, seconds: float = 20.0, trace: bool = False, root: str = core.ROOT):
    """(result, checks, other numbers) of one CPU run of `cell` at the small size; the
    checks that need a long window (the loops of a whole rotloop) are
    left to the card."""
    over = overrides(cell, root)
    res = core.run_cell(cell, SEED, seconds, trace, device="cpu", root=root, overrides=over)
    return res
