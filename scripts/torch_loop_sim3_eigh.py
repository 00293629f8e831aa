"""The constructed-drift closure of ``chip_smoke.py``'s ``loop`` phase with
the Sim3 RANSAC's Horn eigen-solves on the ``sym_eig`` kernel and on
``torch.linalg.eigh``, over several seeds of the RANSAC's generator.

    python3 scripts/torch_loop_sim3_eigh.py [--seeds 0,1,2,3,4]
                                            [--ulps 0] [--dump PATH]

Needs one CUDA card. Each closure runs eagerly (``LoopCloser.graphs``
off) on a fresh copy of the arena at ``SlamConfig()`` capacities with the
repo's vocabulary, as ``chip_smoke.loop_phase`` builds it, with the
generator seeded from the list. Prints one JSON line a closure: the solver,
the seed, whether it closed, the RANSAC Sim3 (scale, rotation angle from
the identity in degrees, translation norm) with its inlier count, the
refined Sim3 likewise, and the segment-B centre error after the correction
and after the global BA as a share of its value before (``chip_smoke``
requires at most ``LOOP_ERR_FRAC``); then the card's name and power limit.
``--ulps`` moves the RANSAC's scale by each given number of float32 units
in the last place before the widening and the refinement receive it: how
far the closure's outcome follows a last-bit change of ComputeSim3's
input (the two loop keyframes share a viewpoint, so the refinement sees
the scale only through a translation of order 1e-7). ``--dump`` writes
the inputs of each solver's first refinement (seed and ulps as listed
first) to an ``.npz`` under the keys of ``scripts/sim3_refine_witness.py``,
which replays them on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402
from cubemapslam_tpu_torch import SlamConfig  # noqa: E402
from cubemapslam_tpu_torch import place as PL  # noqa: E402
from cubemapslam_tpu_torch.camera import CubemapCamera  # noqa: E402
from cubemapslam_tpu_torch.geometry import so3_log  # noqa: E402
from cubemapslam_tpu_torch.runtime import loop_closing as TL  # noqa: E402
from cubemapslam_tpu_torch.runtime.loop_closing import LoopCloser  # noqa
from cubemapslam_tpu_torch.solvers import sim3 as S3  # noqa: E402
from cubemapslam_tpu_torch.solvers import sym_eig as SE  # noqa: E402

SOLVERS = {"sym_eig": SE.sym_eig, "torch.linalg.eigh": torch.linalg.eigh}
# optimize_sim3's arguments after the camera, as the dump names them
SIM3_ARGS = ("s12", "R12", "t12", "p1", "p2", "uv1", "face1", "uv2", "face2",
             "inv_sigma2_1", "inv_sigma2_2", "valid")


def describe(s, R, t):
    return dict(s=float(s), angle_deg=float(torch.rad2deg(
        torch.linalg.norm(so3_log(R.double())))), t_norm=float(
        torch.linalg.norm(t)))


def nudge(s, ulps):
    """``s`` moved by ``ulps`` float32 units in the last place."""
    inf = torch.full_like(s, math.inf if ulps > 0 else -math.inf)
    for _ in range(abs(ulps)):
        s = torch.nextafter(s, inf)
    return s


def closure(cfg, vocab, solver, seed, ulps=0, dump=None):
    system = CS.loop_system(cfg, "cuda", vocab, CS.LOOP_POINTS, CS.SEED + 7)
    system.generator.manual_seed(seed)
    before = CS.segment_b_error(system.arena)
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, "cuda"))
    lc.consistency_th = 1
    lc.graphs = False
    k, rec = lc.k, {}
    ransac, refine, gba = k.sim3_ransac, k.refine_sim3, lc._global_ba
    optimize = TL.optimize_sim3

    def ransac_rec(*args, **kw):
        res = S3.sim3_ransac(
            k.cam, args[5], *k.sim3_candidates(*args[:5]),
            args[4], n_iters=cfg.sim3_ransac_iters, fix_scale=False,
            min_inliers=20, scores=kw.get("scores"), eigh=SOLVERS[solver])
        rec["ransac"] = dict(describe(res.s12, res.R12, res.t12),
                             inliers=int(res.n_inliers))
        return res._replace(s12=nudge(res.s12, ulps))

    def optimize_rec(cam, *args, **kw):
        if dump is not None and not any(k.startswith(solver + "/")
                                        for k in dump):
            dump.update({f"{solver}/{name}": x.detach().cpu().numpy()
                         for name, x in zip(SIM3_ARGS, args)})
        return optimize(cam, *args, **kw)

    def refine_rec(*args):
        TL.optimize_sim3 = optimize_rec
        try:
            out = refine(*args)
        finally:
            TL.optimize_sim3 = optimize
        rec["refined"] = dict(describe(*out[:3]), inliers=int(out[4]))
        return out

    def gba_rec(system):
        rec["after_correct"] = CS.segment_b_error(system.arena) / before
        return gba(system)

    k.sim3_ransac, k.refine_sim3, lc._global_ba = (ransac_rec, refine_rec,
                                                   gba_rec)
    closed = [lc.process(system, slot) for slot in (12, 13)]
    del ransac
    return dict(solver=solver, seed=seed, ulps=ulps, closed=closed, **rec,
                after_gba=CS.segment_b_error(system.arena) / before,
                bound=CS.LOOP_ERR_FRAC)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--ulps", default="0")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg = SlamConfig()
    vocab = PL.load_vocabulary(str(CS.VOCAB_PATH))
    dump = None if args.dump is None else {}
    for seed in (int(x) for x in args.seeds.split(",")):
        for ulps in (int(x) for x in args.ulps.split(",")):
            for solver in SOLVERS:
                print(json.dumps(closure(cfg, vocab, solver, seed, ulps,
                                         dump)), flush=True)
    if dump is not None:
        pathlib.Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.dump, **dump)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
