"""Replay recorded OptimizeSim3 inputs on the CPU: JAX's ``optimize_sim3``
in float32 and in float64, and the port's in float32.

    python3 scripts/sim3_refine_witness.py [PATH.npz] [--face 650]

``PATH.npz`` is what ``scripts/torch_loop_sim3_eigh.py --dump`` wrote on
the card: for each eigen-solver of the Sim3 RANSAC, the arguments that the
constructed-drift closure's ComputeSim3 handed ``optimize_sim3`` (the
RANSAC's Sim3 and the matched pairs); by default the ``sym_eig`` solver's,
kept as ``tests/torch_exact_revisit_sim3.npz``. The camera is ``SlamConfig()``'s at
``--face`` pixel faces. Prints one JSON line a solver: the start scale,
and for each replay the refined scale, its inlier count, and the rotation
(degrees) and translation norm of the refined Sim3. The two loop
keyframes share a viewpoint, so the scale is seen only through the
translation; where a replay's scale leaves the start's, the float32
rounding of its Jacobian's scale column did it (the float64 replay of the
same JAX code is the check).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cubemapslam_tpu.camera import CubemapCamera as JCam  # noqa: E402
from cubemapslam_tpu.config import SlamConfig as JConfig  # noqa: E402
from cubemapslam_tpu.optim import sim3_opt as JO  # noqa: E402
from cubemapslam_tpu_torch.camera import CubemapCamera as TCam  # noqa
from cubemapslam_tpu_torch.config import SlamConfig as TConfig  # noqa
from cubemapslam_tpu_torch.geometry import so3_log  # noqa: E402
from cubemapslam_tpu_torch.optim import sim3_opt as TO  # noqa: E402

SIM3_ARGS = ("s12", "R12", "t12", "p1", "p2", "uv1", "face1", "uv2", "face2",
             "inv_sigma2_1", "inv_sigma2_2", "valid")


def describe(out):
    s, R, t, _, n = (np.array(x, np.float64) for x in out)
    angle = float(torch.linalg.norm(so3_log(torch.as_tensor(R))))
    return dict(s=float(s), inliers=int(n), angle_deg=float(np.degrees(
        angle)), t_norm=float(np.linalg.norm(t)))


def replay(face, args):
    args = [a.astype(np.int64) if a.dtype == np.int8 else a for a in args]
    kw = dict(th2=10.0, fix_scale=False)
    jcfg = JConfig(cube_face_w=face, cube_face_h=face)
    out = {"jax.float32": describe(JO.optimize_sim3(
        JCam.from_config(jcfg), *map(jnp.asarray, args), **kw))}
    with jax.enable_x64(True):
        a64 = [a.astype(np.float64) if a.dtype == np.float32 else a
               for a in args]
        cam64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), JCam.from_config(jcfg))
        out["jax.float64"] = describe(JO.optimize_sim3(
            cam64, *map(jnp.asarray, a64), **kw))
    tcfg = TConfig(cube_face_w=face, cube_face_h=face)
    out["port.float32"] = describe(TO.optimize_sim3(
        TCam.from_config(tcfg, "cpu"), *map(torch.as_tensor, args), **kw))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "tests"
        / "torch_exact_revisit_sim3.npz"))
    ap.add_argument("--face", type=int, default=650)
    args = ap.parse_args()
    torch.set_num_threads(1)
    data = np.load(args.path)
    for solver in sorted({k.split("/")[0] for k in data.files}):
        case = [data[f"{solver}/{k}"] for k in SIM3_ARGS]
        print(json.dumps(dict(solver=solver, start_s=float(case[0]),
                              pairs=int(case[-1].sum()),
                              **replay(args.face, case))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
