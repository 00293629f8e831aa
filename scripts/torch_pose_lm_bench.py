"""Time the pose-LM kernel at every cluster size on the card.

    python3 scripts/torch_pose_lm_bench.py [--rounds 2] [--split]
                                           [--out JSON]

For each cluster size of ``pose_opt.LM_CLUSTERS`` and each seeded problem of
``chip_smoke`` (``lm_problem`` at ``LM_SIZES``, as ``check_pose_lm`` seeds
them) and no edge at all, it checks the kernel bitwise against
``pose_optimization_ordered`` (R, t, the inlier mask, its count, the
iterations a round), then times the device ms of a solve from a CUDA graph
(``chip_smoke.graph_ms``) ``--rounds`` times, and its time a pass (44 passes
with no edge: the serial floor). Prints the ptxas lines of each cluster
size, one line a size and input, the card's name and power limit, and a
JSON summary (also written to ``--out``); exits 1 if the kernel differs from
the plain version anywhere. With ``--split``, the source is also built with
``-DPOSE_LM_SPLIT`` and run at each size and input: thread 0 of block 0
reads the SM clock around each part of a pass (the edges' terms, the
slices' hand-over, the warp reduction and its sending, the wait for every
block's sums, the sums read and added, the accept test and lambda, the 6x6
solve, the pose step), printed as clocks a pass beside the SM clock
``nvidia-smi`` reads.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from cubemapslam_tpu_torch import SlamConfig, _build  # noqa: E402
from cubemapslam_tpu_torch.camera import CubemapCamera  # noqa: E402
from cubemapslam_tpu_torch.optim import pose_opt as PO  # noqa: E402

SPLIT_PARTS = ("terms", "hand_over", "reduce", "wait", "gather", "judge",
               "solve", "step")


def build_split():
    """``pose_lm_launch`` of ``csrc/pose_lm.cu`` built with the package's
    flags and ``-DPOSE_LM_SPLIT``; (kernel, the library)."""
    src = _build.CSRC / "pose_lm.cu"
    cmd_flags = [*_build._flags("pose_lm.cu"), "-DPOSE_LM_SPLIT"]
    digest = hashlib.sha256(src.read_bytes() + " ".join(cmd_flags).encode())
    lib = _build.BUILD_DIR / f"bench_pose_lm_{digest.hexdigest()[:12]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([_build._nvcc(), *cmd_flags, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed (-DPOSE_LM_SPLIT):\n{done.stdout}"
                           f"{done.stderr}")
    k = _build.CudaKernel("pose_lm.cu", PO.POSE_LM.symbol,
                          PO.POSE_LM.argtypes[:-1])
    so = ctypes.CDLL(str(lib))
    fn = getattr(so, k.symbol)
    fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    k._fn = fn
    return k, so


def sm_clock_mhz() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def with_kernel(kernel, fn):
    """``fn`` with ``pose_opt.POSE_LM`` swapped for ``kernel``."""
    def call():
        keep, PO.POSE_LM = PO.POSE_LM, kernel
        try:
            return fn()
        finally:
            PO.POSE_LM = keep
    return call


def split(cam, inputs, reps=20):
    """Clocks a pass by part (thread 0 of block 0) of the -DPOSE_LM_SPLIT
    build, at every cluster size and input."""
    k, lib = build_split()
    take = lib.pose_lm_split_take
    take.argtypes, take.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_ulonglong * (len(SPLIT_PARTS) + 1))()
    rows = []
    for cluster in PO.LM_CLUSTERS:
        for n, prob in inputs:
            run = with_kernel(k, lambda: PO.pose_lm(cam, *prob,
                                                    cluster=cluster))
            run()
            torch.cuda.synchronize()
            if take(buf) != 0:
                raise RuntimeError("pose_lm_split_take failed")
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            clock = sm_clock_mhz()
            if take(buf) != 0:
                raise RuntimeError("pose_lm_split_take failed")
            passes = max(int(buf[len(SPLIT_PARTS)]), 1)
            parts = {p: buf[i] / passes for i, p in enumerate(SPLIT_PARTS)}
            rows.append(dict(cluster=cluster, n=n, passes=passes / reps,
                             clocks=parts, sm_clock_mhz=clock))
            print(f"[pose_lm_bench] split C={cluster} N={n}: clocks a pass "
                  + ", ".join(f"{p} {v:.0f}" for p, v in parts.items())
                  + f"; total {sum(parts.values()):.0f}; SM clock, max "
                  f"(MHz) {clock}", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="timings of each size and input")
    ap.add_argument("--split", action="store_true",
                    help="also time the parts of a pass (SM clocks)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    ptxas = CS.lm_ptxas_lines(
        _build.build_all(["pose_lm.cu"]).get("pose_lm.cu", ""))
    for line in ptxas:
        print(f"[pose_lm_bench] ptxas {line}", flush=True)
    cfg = SlamConfig()
    cam = CubemapCamera.from_config(cfg, "cuda")
    problems = {n: CS.lm_problem(cfg, n, CS.SEED + 5, "cuda")
                for n in CS.LM_SIZES}
    empty = [a[:0] if k >= 2 else a for k, a in
             enumerate(problems[CS.LM_SIZES[0]])]
    inputs = list(problems.items()) + [(0, empty)]
    ok, rows = True, []
    for cluster in PO.LM_CLUSTERS:
        for n, prob in inputs:
            ref = PO.pose_optimization_ordered(cam, *prob)
            passes = 44 if n == 0 else sum(1 + int(i) for i in ref[4])
            out = PO.pose_lm(cam, *prob, cluster=cluster)
            same = bool(torch.equal(out[0], ref[0])
                        and torch.equal(out[1], ref[1])
                        and torch.equal(out[2], ref[2])
                        and int(out[3]) == int(ref[3])
                        and torch.equal(out[4].long(), ref[4].long()))
            ok &= same
            t = [CS.graph_ms(lambda: PO.pose_lm(cam, *prob, cluster=cluster))
                 for _ in range(args.rounds)]
            rows.append(dict(cluster=cluster, n=n, passes=passes,
                             device_ms=t, bitwise=same))
            print(f"[pose_lm_bench] C={cluster} N={n}: device "
                  f"{min(t):.5f}-{max(t):.5f} ms, {passes} passes, "
                  f"{min(t) / passes * 1e3:.3f} us a pass, bitwise {same}",
                  flush=True)
    splits = split(cam, inputs) if args.split else []
    smi = CS.nvidia_smi_line()
    print(smi)
    summary = dict(card=smi, ptxas=ptxas, rows=rows, splits=splits, ok=ok)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
