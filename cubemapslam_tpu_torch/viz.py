"""Visualization: map/trajectory rendering and frame overlays (headless).

Counterpart of ``cubemapslam_tpu/viz.py``, on the port's ``CubemapSLAM``:
matplotlib artifacts in place of the reference's Pangolin viewer
(Viewer.{h,cpp}, MapDrawer.{h,cpp}, FrameDrawer.{h,cpp}). The map view draws
landmarks, keyframe centres, the covisibility graph and the trajectory
(MapDrawer::DrawMapPoints / DrawKeyFrames); the frame view overlays the
tracked keypoints with a status bar (FrameDrawer::DrawFrame) and keeps the
tracking summary (OutputTrackingSummary).

Tensors are read to the host only inside a draw, every ``every_n`` ticks of
the ``Viewer``; matplotlib (Agg) is imported there too, so a run without a
draw needs no matplotlib.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from cubemapslam_tpu_torch import slam_map as SM


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


class FrameDrawer:
    """Per-frame overlay and running statistics."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_tracked_points = 0
        self.n_tracked_frames = 0

    def update(self, n_inliers: int):
        if n_inliers > 0:
            self.n_tracked_points += n_inliers
            self.n_tracked_frames += 1

    def summary(self) -> str:
        """OutputTrackingSummary analog."""
        avg = (self.n_tracked_points / self.n_tracked_frames
               if self.n_tracked_frames else 0.0)
        return (f"tracked frames: {self.n_tracked_frames}, "
                f"avg tracked map points/frame: {avg:.1f}")

    def draw(self, image, kp_uv, matched, valid, state: str, n_kf: int,
             n_lm: int, path: str):
        """Save the cubemap image with keypoint overlays and a status
        bar."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        uv, matched, valid = _host(kp_uv), _host(matched), _host(valid)
        m = matched & valid
        o = ~matched & valid
        fig, ax = plt.subplots(figsize=(8, 8.4))
        ax.imshow(_host(image), cmap="gray", vmin=0, vmax=255)
        ax.scatter(uv[m, 0], uv[m, 1], s=8, facecolors="none",
                   edgecolors="lime", linewidths=0.8, label="tracked")
        ax.scatter(uv[o, 0], uv[o, 1], s=4, facecolors="none",
                   edgecolors="deepskyblue", linewidths=0.5,
                   label="unmatched")
        ax.set_title(f"{state} | KFs: {n_kf} | MPs: {n_lm} | "
                     f"matches: {int(m.sum())}")
        ax.legend(loc="lower right", fontsize=7)
        ax.set_axis_off()
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)


class MapDrawer:
    """Map and trajectory rendering."""

    def __init__(self, cfg):
        self.cfg = cfg

    def draw(self, arena: SM.MapArena, trajectory, path: str,
             covis_th: int = 15):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        lm = _host(arena.lm_pos)
        lv = _host(arena.lm_valid)
        kfv = _host(arena.kf_valid)
        Rs = _host(arena.kf_R)
        ts = _host(arena.kf_t)
        centers = -np.einsum("kji,kj->ki", Rs, ts)
        covis = _host(SM.covisibility_matrix(arena))

        fig, axes = plt.subplots(1, 2, figsize=(14, 7))
        ii, jj = np.where(np.triu(covis) >= covis_th)
        for ax, (a, b), name in [(axes[0], (0, 2), "top (x-z)"),
                                 (axes[1], (0, 1), "front (x-y)")]:
            ax.scatter(lm[lv, a], lm[lv, b], s=1, c="k", alpha=0.4,
                       label="landmarks")
            for i, j in zip(ii, jj):
                if kfv[i] and kfv[j]:
                    ax.plot([centers[i, a], centers[j, a]],
                            [centers[i, b], centers[j, b]],
                            c="lightgray", lw=0.4, zorder=1)
            ax.scatter(centers[kfv, a], centers[kfv, b], s=14, c="b",
                       marker="s", label="keyframes", zorder=3)
            if trajectory:
                tr = np.stack([-R.T @ t for (_, R, t) in trajectory])
                ax.plot(tr[:, a], tr[:, b], c="g", lw=1.0,
                        label="trajectory", zorder=2)
            ax.set_title(name)
            ax.set_aspect("equal")
            ax.legend(fontsize=7)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)


class Viewer:
    """Headless viewer loop: every ``every_n`` ticks it writes the map view
    and, given the tick's image, the frame view into ``out_dir`` (the
    Pangolin window of Viewer.cpp becomes a directory the user can watch;
    localization mode is toggled on the system itself)."""

    def __init__(self, system, out_dir: str, every_n: int = 20):
        self.system = system
        self.out_dir = out_dir
        self.every_n = every_n
        self.frame_drawer = FrameDrawer(system.cfg)
        self.map_drawer = MapDrawer(system.cfg)
        os.makedirs(out_dir, exist_ok=True)
        self._count = 0

    def tick(self, image: Optional[np.ndarray] = None):
        """After each tracked frame; ``image`` is the frame's cubemap
        cross (array or tensor), drawn when given."""
        s = self.system
        if s.metrics:
            self.frame_drawer.update(s.metrics[-1].get("inliers", 0))
        self._count += 1
        if self._count % self.every_n:
            return
        self.map_drawer.draw(
            s.arena, s.trajectory,
            os.path.join(self.out_dir, f"map_{self._count:06d}.png"))
        last = getattr(s, "last", None)
        if image is not None and last is not None:
            self.frame_drawer.draw(
                image, last.kp.uv, last.assoc >= 0, last.kp.valid,
                s.state.name, s.n_kf, int(s.arena.lm_valid.sum()),
                os.path.join(self.out_dir, f"frame_{self._count:06d}.png"))
