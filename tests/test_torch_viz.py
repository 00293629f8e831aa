"""Port parity: the headless viewer (``cubemapslam_tpu_torch.viz``).

A ``Viewer`` with ``every_n=5`` over 10 cubemap frames that the port's
``CubemapSLAM`` tracks on the CPU (the JAX e2e test's small configuration
and world, ``tests/test_serialize_viz.py``'s viewer schedule) writes the
map and frame PNGs at ticks 5 and 10, and its tracking summary is the
string the JAX ``FrameDrawer`` makes of the same per-frame inlier counts.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from cubemapslam_tpu.config import SlamConfig as JConfig
from cubemapslam_tpu.viz import FrameDrawer as JFrameDrawer
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.runtime import synthetic as S
from cubemapslam_tpu_torch.runtime.system import CubemapSLAM, TrackState
from cubemapslam_tpu_torch.viz import Viewer

E2E = dict(cube_face_w=160, cube_face_h=160, n_features=600, n_levels=3,
           max_keyframes=24, max_landmarks=4096, min_init_keypoints=80,
           min_init_matches=60, min_track_inliers=20, fps=5.0)
N_FRAMES = 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_viewer_writes_artifacts_and_summary(tmp_path):
    cfg = SlamConfig(**E2E)
    slam = CubemapSLAM(cfg, device="cpu")
    slam.loop_closing_enabled = False
    render = S.Renderer(CubemapCamera.from_config(cfg, "cpu"), cfg,
                        target="cubemap")
    world = S.make_world(np.random.default_rng(42), n=600)
    viewer = Viewer(slam, str(tmp_path / "viz"), every_n=5)
    inliers = []
    for k, (R, t) in enumerate(S.forward_trajectory(N_FRAMES)):
        cross = render.render(*world, R, t)[0]
        slam.track_cubemap(torch.as_tensor(cross), k / cfg.fps)
        viewer.tick(cross)
        inliers.append(slam.metrics[-1].get("inliers", 0))
    assert slam.state == TrackState.OK
    names = sorted(p.name for p in (tmp_path / "viz").iterdir())
    assert names == ["frame_000005.png", "frame_000010.png",
                     "map_000005.png", "map_000010.png"]
    for name in names:
        with Image.open(tmp_path / "viz" / name) as im:
            assert im.size[0] > 100 and im.size[1] > 100
    ref = JFrameDrawer(JConfig(**E2E))
    for n in inliers:
        ref.update(n)
    assert viewer.frame_drawer.n_tracked_frames > 5
    assert viewer.frame_drawer.summary() == ref.summary()
    assert "avg tracked map points/frame" in ref.summary()


def test_viewer_without_a_tracked_frame_draws_the_map(tmp_path):
    """Before any frame the system has no last frame: a draw tick writes
    the (empty) map view and no frame view."""
    slam = CubemapSLAM(SlamConfig(**E2E), device="cpu")
    viewer = Viewer(slam, str(tmp_path / "viz"), every_n=1)
    viewer.tick(np.zeros((480, 480), np.float32))
    assert sorted(p.name for p in (tmp_path / "viz").iterdir()) == [
        "map_000001.png"]
    assert viewer.frame_drawer.summary() == JFrameDrawer(
        JConfig(**E2E)).summary()
