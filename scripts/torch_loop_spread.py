"""Card-against-CPU spread of the port's loop closure on a CUDA card.

    python3 scripts/torch_loop_spread.py [--runs 3]

Needs one CUDA card. Works on the constructed-drift arena of
``chip_smoke.py``'s small loop check (K=64, N=600, L=8192, 500 points):

- the correction (``chip_smoke.small_loop_closure``: ``process`` on slots
  12 and 13 with the global BA held back) once on the CPU and ``--runs``
  times on the card with the card's own refined Sim3, then ``--runs``
  times from the CPU's; one JSON line each with its gap from the CPU
  (``chip_smoke.arena_gap``: the largest pose entry, the 99% quantile and
  the largest landmark coordinate over the landmarks live in both, the
  share of the live observation table that is equal), the largest entry of
  the RANSAC Sim3's and of the refined rotation's and translation's
  difference, and both refined scales;
- the global BA from the CPU's corrected arena: on the CPU in float64 (the
  witness), in float32 in the arena's edge order and in 2 shuffled orders,
  and ``--runs`` times on the card, one line each with its gap from the
  float32 CPU run and from the witness.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402
from cubemapslam_tpu_torch.camera import CubemapCamera  # noqa: E402
from cubemapslam_tpu_torch.config import SlamConfig  # noqa: E402
from cubemapslam_tpu_torch.dist import global_ba_problem_from_arena  # noqa: E402
from cubemapslam_tpu_torch.optim.ba import bundle_adjust  # noqa: E402

LIVE_FIELDS = ("obs_cam", "obs_pt", "obs_face", "obs_uv", "obs_inv_sigma2",
               "obs_valid")


def global_ba(arena, cam, inv_s2, dtype=torch.float32, order_seed=None):
    """The loop closer's global BA on ``arena`` (its device), on the live
    edges in the arena's order or shuffled by ``order_seed``, in
    ``dtype``. Returns the arena after it, on the CPU, in float32."""
    prob = global_ba_problem_from_arena(cam, arena, inv_s2)
    keep = prob.obs_valid.nonzero()[:, 0]
    if order_seed is not None:
        g = torch.Generator().manual_seed(order_seed)
        keep = keep[torch.randperm(keep.shape[0], generator=g).to(
            keep.device)]
    live = prob._replace(**{f: getattr(prob, f)[keep] for f in LIVE_FIELDS})
    live = live._replace(R=live.R.to(dtype), t=live.t.to(dtype),
                         X=live.X.to(dtype), obs_uv=live.obs_uv.to(dtype),
                         obs_inv_sigma2=live.obs_inv_sigma2.to(dtype))
    out, _ = bundle_adjust(cam, live, phase_iters=(5, 10), solver="cg",
                           cg_iters=50)
    a = arena.to("cpu")
    a.kf_R.copy_(out.R.float().cpu())
    a.kf_t.copy_(out.t.float().cpu())
    a.lm_pos.copy_(out.X.float().cpu())
    return a


def gap(c, g):
    return dict(zip(("dpose", "lm_q99", "lm_max", "obs_equal"),
                    CS.arena_gap(c, g)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg = SlamConfig(**CS.LOOP_SMALL)
    _, c_arena, c_rec, c_lc = CS.small_loop_closure(cfg, "cpu")
    for refined in (None, c_rec["refined"]):
        for r in range(args.runs):
            _, g_arena, g_rec, _ = CS.small_loop_closure(cfg, "cuda",
                                                         refined)
            print(json.dumps(dict(
                part="correction",
                sim3="the CPU's refined" if refined else "own", run=r,
                ransac_max=max(float((a - b).abs().max()) for a, b in zip(
                    c_rec["ransac"], g_rec["ransac"])),
                refined_Rt_max=max(float((a - b).abs().max()) for a, b in zip(
                    c_rec["refined"][1:3], g_rec["refined"][1:3])),
                refined_scale=(float(c_rec["refined"][0]),
                               float(g_rec["refined"][0])),
                **gap(c_arena, g_arena))), flush=True)
    inv_s2 = c_lc.k.inv_level_sigma2
    cam = c_lc.cam
    witness = global_ba(c_arena, cam, inv_s2, dtype=torch.float64)
    base = global_ba(c_arena, cam, inv_s2)
    print(json.dumps(dict(part="gba", run="cpu float32",
                          vs_witness=gap(witness, base))), flush=True)
    for seed in (1, 2):
        a = global_ba(c_arena, cam, inv_s2, order_seed=seed)
        print(json.dumps(dict(part="gba", run=f"cpu shuffled {seed}",
                              **gap(base, a), vs_witness=gap(witness, a))),
              flush=True)
    g_cam = CubemapCamera.from_config(cfg, "cuda")
    for r in range(args.runs):
        a = global_ba(c_arena.to("cuda"), g_cam, inv_s2.cuda())
        print(json.dumps(dict(part="gba", run=r, **gap(base, a),
                              vs_witness=gap(witness, a))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
