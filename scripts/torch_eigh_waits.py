"""Host waits of the symmetric eigen-solves on a CUDA card, by device and
solver: per call shape for ``torch.linalg.eigh`` (cuSOLVER) and for
``solvers.sym_eig.sym_eig`` (the hand-written kernel), and per call site of
one ``pnp_ransac`` (its six solves on the kernel) and of one
``sim3_ransac`` (its two Horn solves on the kernel).

    python3 scripts/torch_eigh_waits.py

Needs one CUDA card; the counts are the card's (on CPU tensors both solvers
run on the host, with no device to wait for). A host wait is what
``chip_smoke.py`` counts: a profiler event of the host that synchronises
with the card, or a blocking ``cudaMemcpy``. Each case runs once to warm up
and once under ``torch.profiler``. Prints one JSON line per solver and
shape (its waits and their event names), then one per call site of
``pnp_ransac`` (the ``pnp._eigh`` calls labelled in call order, with their
shapes and waits) for each of a few hypothesis counts and point counts,
with the whole call's waits beside ``pnp.EIGH_WAITS`` (0); then the same
for ``sim3_ransac`` (its ``sym_eig`` calls, passed as its ``eigh``) beside
``sim3.EIGH_WAITS`` (0). Exits 1 if a total differs from its constant.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cubemapslam_tpu_torch import camera as TC
from cubemapslam_tpu_torch.camera import CubemapCamera
from cubemapslam_tpu_torch.config import SlamConfig
from cubemapslam_tpu_torch.geometry import so3_exp
from cubemapslam_tpu_torch.solvers import pnp as PNP
from cubemapslam_tpu_torch.solvers import sim3 as S3
from cubemapslam_tpu_torch.solvers import sym_eig as SE
from cubemapslam_tpu_torch.solvers.sampling import sample_minimal_sets

SHAPES = ((3, 3), (1, 3, 3), (2, 3, 3), (300, 3, 3), (4, 4), (3, 4, 4),
          (300, 4, 4), (300, 3, 4, 4), (12, 12), (2, 12, 12),
          (300, 12, 12))
SOLVERS = {"torch.linalg.eigh": torch.linalg.eigh, "sym_eig": SE.sym_eig}


def is_wait(e) -> bool:
    return e.device_type == DeviceType.CPU and (
        "Synchronize" in e.name or e.name == "cudaMemcpy")


def profiled(fn):
    """Run ``fn`` once to warm up, then once under the profiler: its
    events."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def waits_inside(events, spans):
    return [e for e in events if is_wait(e)
            and any(a <= e.time_range.start < b for a, b in spans)]


def shape_case(solver, shape, dev):
    g = torch.Generator().manual_seed(0)
    A = torch.randn(shape, generator=g)
    A = (A @ A.transpose(-1, -2)).to(dev)

    def call():
        with record_function("eigh"):
            SOLVERS[solver](A)

    ev = profiled(call)
    spans = [(e.time_range.start, e.time_range.end) for e in ev
             if e.name == "eigh" and e.device_type == DeviceType.CPU]
    w = waits_inside(ev, spans)
    return dict(case="eigh", solver=solver, shape=list(shape),
                waits=len(w), events=sorted({e.name for e in w}))


def pnp_scene(cam, rng, n):
    pts = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    R = so3_exp(torch.tensor([0.2, -0.3, 0.1]))
    t = torch.tensor([0.4, -0.2, 0.6])
    pw = torch.as_tensor(pts)
    pc = pw @ R.T + t
    rays = pc / torch.linalg.norm(pc, dim=1, keepdim=True)
    uv, face = TC.ray_to_cubemap(cam, rays)
    return pw, rays, uv, face != TC.UNKNOWN_FACE


def pnp_case(n_iters, n_points, dev):
    """One ``pnp_ransac`` with every eigh call in a range of its own,
    labelled by call order and shape: the waits inside each range, and
    those of the whole call."""
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, dev)
    pw, rays, uv, valid = pnp_scene(CubemapCamera.from_config(cfg, "cpu"),
                                    np.random.default_rng(1), n_points)
    # on the card before the profiled call, whose upload would wait too
    sets = sample_minimal_sets(torch.Generator().manual_seed(0), valid,
                               n_iters, PNP.MIN_SET).to(dev)
    args = [x.to(dev) for x in (pw, rays, uv, torch.ones(n_points), valid)]
    return site_case("pnp", lambda: PNP.pnp_ransac(
        cam, None, *args, n_iters=n_iters, sets=sets), n_iters, n_points,
        PNP.EIGH_WAITS, PNP, "_eigh")


def sim3_case(n_iters, n_points, dev):
    """One ``sim3_ransac`` (its own generator on the card) on two point
    sets related by a Sim3, every ``sym_eig`` call labelled as in
    ``pnp_case``."""
    cfg = SlamConfig()
    cam_c = CubemapCamera.from_config(cfg, "cpu")
    p2, _, _, _ = pnp_scene(cam_c, np.random.default_rng(2), n_points)
    R = so3_exp(torch.tensor([0.1, 0.2, -0.05]))
    p1 = 1.3 * p2 @ R.T + torch.tensor([0.5, -0.3, 0.2])
    uv1, f1 = TC.ray_to_cubemap(cam_c, p1)
    uv2, f2 = TC.ray_to_cubemap(cam_c, p2)
    valid = (f1 != TC.UNKNOWN_FACE) & (f2 != TC.UNKNOWN_FACE)
    ones = torch.ones(n_points)
    args = [x.to(dev) for x in (p1, p2, uv1, uv2, ones, ones, valid)]
    cam = CubemapCamera.from_config(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return site_case("sim3", lambda: S3.sim3_ransac(
        cam, gen, *args, n_iters=n_iters, eigh=lambda A: SE.sym_eig(A)),
        n_iters, n_points, S3.EIGH_WAITS, SE, "sym_eig")


def site_case(tag, run, n_iters, n_points, expected, owner, attr):
    """The waits of each labelled call of the eigen-solve ``owner.attr``
    inside ``run()`` and of the whole call, as JSON rows, and the total
    row."""
    eigh = getattr(owner, attr)
    sites = []

    def labelled(A, *a, **kw):
        name = f"eigh#{len(sites)}"
        sites.append((name, list(A.shape)))
        with record_function(name):
            return eigh(A, *a, **kw)

    def call():
        sites.clear()
        with record_function(tag):
            run()

    setattr(owner, attr, labelled)
    try:
        ev = profiled(call)
    finally:
        setattr(owner, attr, eigh)

    def spans(name):
        return [(e.time_range.start, e.time_range.end) for e in ev
                if e.name == name and e.device_type == DeviceType.CPU]

    rows = [dict(case=f"{tag}_site", n_iters=n_iters, n_points=n_points,
                 site=name, shape=shape,
                 waits=len(waits_inside(ev, spans(name))))
            for name, shape in sites]
    total = len(waits_inside(ev, spans(tag)))
    return rows, dict(case=f"{tag}_total", n_iters=n_iters,
                      n_points=n_points, eigh_calls=len(sites),
                      eigh_waits=sum(r["waits"] for r in rows),
                      all_waits=total, EIGH_WAITS=expected)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(json.dumps(dict(card=torch.cuda.get_device_name(0),
                          torch=torch.__version__,
                          cuda=torch.version.cuda)))
    for solver in SOLVERS:
        for shape in SHAPES:
            print(json.dumps(shape_case(solver, shape, dev)))
    ok = True
    for case in (pnp_case, sim3_case):
        for n_iters, n_points in ((300, 150), (300, 2000), (50, 150)):
            rows, total = case(n_iters, n_points, dev)
            for r in rows:
                print(json.dumps(r))
            print(json.dumps(total))
            ok &= (total["all_waits"] == total["eigh_waits"]
                   == total["EIGH_WAITS"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
