"""The JAX package's loop e2e circuit, as the reference for the port's.

    JAX_PLATFORMS=cpu python3 tests/torch_loop_e2e_reference.py [--seed 42]

A script beside the tests, not a test (pytest does not collect it), since
it runs the JAX package, which the port's scripts never import. It runs
``tests/test_loop_e2e.py::test_closes_loop_and_reduces_ate`` of the JAX
package (170 frames of the tangent-facing circuit through a seeded world of
1500 billboards, the test's configuration and pretrained vocabulary) with
the world drawn from ``--seed``, as ``scripts/torch_loop_e2e.py --seed``
draws the port's, and with ``jax_threefry_partitionable`` as the JAX
package's tests run. It imports nothing of the port. It prints, per
closure, the frame and the largest |R^T R - I| over the live keyframes just
after it, then a JSON summary: the keyframe ATE (Sim3-aligned) after the
circuit, the loops closed, the final state and the largest |R^T R - I|
over the returned rotations before the first closure, after it, and over
all of them (``rotation_orthonormality_error``, the port script's
measure). It says whether the reference itself lets the rotations leave
SO(3) in the tracking frames after a closure. About 8 minutes a world on
8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))   # test_loop_e2e

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cubemapslam_tpu.runtime.system import CubemapSLAM  # noqa: E402
from cubemapslam_tpu.synth import (Renderer, loop_trajectory,  # noqa: E402
                                   make_world)
from cubemapslam_tpu.warp import fov_mask  # noqa: E402
from test_loop_e2e import ate_of, loop_cfg, pretrained_vocab  # noqa: E402

N_FRAMES = 170
# as the JAX package's tests run (tests/conftest.py)
jax.config.update("jax_threefry_partitionable", True)


def departure(R) -> float:
    R = np.asarray(R, np.float64)
    return float(np.abs(R.T @ R - np.eye(3)).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42,
                    help="the world's seed (the test's rng fixture: 42)")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    poses = loop_trajectory(N_FRAMES, radius=3.0, n_loops=1.25,
                            facing="tangent")
    centres = np.stack([-R.T @ t for R, t in poses])
    pts, patches = make_world(rng, n=1500, centers=centres)
    probe = CubemapSLAM(loop_cfg())
    mask = fov_mask(probe.cam, probe.cfg.cube_w, probe.cfg.cube_h)
    ren = Renderer(probe.cam, probe.cfg, "cubemap")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        voc = pretrained_vocab(rng, pts, patches, ren, probe.extract, mask,
                               pathlib.Path(tmp))
        slam = CubemapSLAM(loop_cfg(vocab_path=voc))
    closed_at, kf_after = [], []
    for k, (R, t) in enumerate(poses):
        n0 = slam.n_loops_closed
        slam.track_cubemap(jnp.asarray(ren.render(pts, patches, R, t)),
                           k * 0.1, mask=mask)
        if slam.n_loops_closed > n0:
            valid = np.asarray(slam.arena.kf_valid)
            Rs = np.asarray(slam.arena.kf_R)[valid]
            closed_at.append(k)
            kf_after.append(max(departure(r) for r in Rs))
            print(f"[reference] frame {k}: loop closed, {int(valid.sum())} "
                  f"live keyframes, largest |R^T R - I| {kf_after[-1]:.4g}",
                  flush=True)
    stamps = [k * 0.1 for k in range(N_FRAMES)]
    first = stamps[closed_at[0]] if closed_at else None
    dep = [(ts, departure(R)) for ts, R, _ in slam.trajectory]
    before = [d for ts, d in dep if first is None or ts <= first + 1e-9]
    after = [d for ts, d in dep if first is not None and ts > first + 1e-9]
    summary = dict(
        seed=args.seed, frames=N_FRAMES, tracked=len(slam.trajectory),
        state=slam.state.name, loops_closed=slam.n_loops_closed,
        closed_at_frames=closed_at, keyframes_after_closure=kf_after,
        ate_post=ate_of(slam, centres),
        departure_before_closure=max(before, default=0.0),
        departure_after_closure=max(after, default=0.0),
        rotation_orthonormality_error=max((d for _, d in dep), default=0.0),
        seconds=time.perf_counter() - t0)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
