"""The benchmark's frozen renderer against the port's synthetic scene."""

import numpy as np

from slam_bench.scene import render


def test_renderer_matches_the_port_pixel_for_pixel():
    from aria_slam_tpu_torch.config import CameraConfig
    from aria_slam_tpu_torch.io import synthetic_scene as ss

    cam = CameraConfig(width=188, height=120, fx=114.66, fy=114.32, cx=91.8, cy=62.1,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    mine_cam = render.Camera(188, 120, 114.66, 114.32, 91.8, 62.1)
    layers = render.scene_layers(4.0, 3)
    port_layers = ss.scene_layers(4.0, 3)
    for (c1, t1), (c2, t2) in zip(layers, port_layers):
        assert np.array_equal(c1, c2) and np.array_equal(t1, t2)
    obj = render.texture(512, 3 + 999)
    assert np.array_equal(obj, ss._texture(512, 3 + 999))
    times = np.arange(12) * 0.7
    got = render.render(mine_cam, times, layers, kind="rotloop", moving=(obj, 0.9, 1.0),
                        device="cpu")
    differing = 0
    for k, t in enumerate(times):
        pos, R = ss.trajectory(t, kind="rotloop")
        img = ss.render_frame(cam, None, pos, R, layers=port_layers)
        out = ss._warp_plane(cam, obj, ss.moving_object_state(t), R, pos)
        if out is not None:
            img = np.where(out[1] > 0, out[0], img)
        differing += int((img != got[k]).sum())
    assert differing == 0, f"{differing} of {got.size} pixels differ from the port's"


def test_imu_matches_the_port():
    from aria_slam_tpu_torch.io import synthetic_scene as ss

    for traj in ("sweep", "rotloop"):
        a = ss.imu_samples(3.0, traj=traj, seed=5)
        b = render.imu_samples(3.0, traj=traj, seed=5)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
