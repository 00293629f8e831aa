"""Time builds of the segmented-sum kernel against ``index_add_`` on the card.

    python3 scripts/torch_seg_sum_bench.py [--source NAME=PATH ...]
                                           [--rounds 2] [--out JSON]

Builds each source (by default the package's ``csrc/seg_sum.cu``) with the
package's ``nvcc`` flags into ``build/torch_kernels/``; each must expose
``seg_sum_launch`` with the package's C signature, so two versions of the
kernel (say a working copy and a variant) can be compared within one call
on one card. At every ``chip_smoke.SEG_SHAPES`` case (seeded by
``chip_smoke.seg_case``) it checks each build bitwise against
``segment.segment_sum_ordered`` and times its device ms from a CUDA graph
(``chip_smoke.graph_ms``) in rounds that run the sources in the given order
and then reversed (A B B A ...), beside ``index_add_`` into zeros; then it
holds each build bitwise at every ``chip_smoke.SEG_EDGES`` case. The bound
is ``chip_smoke.seg_bound``. Prints one line a shape and source, the card's
name and power limit, and a JSON summary (also written to ``--out``);
exits 1 if a build differs from the plain version anywhere.
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
from cubemapslam_tpu_torch import _build  # noqa: E402
from cubemapslam_tpu_torch import segment as SG  # noqa: E402


def build(path: pathlib.Path) -> _build.CudaKernel:
    """``seg_sum_launch`` of one source, built with the package's flags."""
    src = path.read_bytes()
    digest = hashlib.sha256(src + " ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / f"bench_{path.stem}_{digest.hexdigest()[:12]}.so"
    if not lib.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(lib), str(path)], capture_output=True,
                              text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{done.stdout}"
                               f"{done.stderr}")
    k = _build.CudaKernel(path.name, SG.SEG_SUM.symbol,
                          SG.SEG_SUM.argtypes[:-1])
    fn = getattr(ctypes.CDLL(str(lib)), k.symbol)
    fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    k._fn = fn
    return k


def with_kernel(kernel, fn):
    """``fn`` with ``segment.SEG_SUM`` swapped for ``kernel``."""
    def call():
        keep, SG.SEG_SUM = SG.SEG_SUM, kernel
        try:
            return fn()
        finally:
            SG.SEG_SUM = keep
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of a seg_sum source (repeatable)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="timing rounds, each over every source and back")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sources = dict(s.split("=", 1) for s in args.source) or {
        "tree": str(_build.CSRC / "seg_sum.cu")}
    kernels, ok = {}, True
    for name, p in sources.items():
        try:
            kernels[name] = build(pathlib.Path(p))
        except RuntimeError as e:   # the other sources are still timed
            print(f"[seg_sum_bench] {name}: {e}", flush=True)
            ok = False
    order = list(kernels) + list(kernels)[::-1]
    rows = []
    for shape in CS.SEG_SHAPES:
        plan, v = CS.seg_case(shape, "cuda")
        ref = SG.segment_sum_ordered(plan, v)
        b_ms, b_by = CS.seg_bound(plan, v)

        def lib(plan=plan, v=v):
            return torch.zeros((plan.n + 1,) + tuple(v.shape[1:]),
                               device="cuda").index_add_(0, plan.idx, v)[:-1]

        row = dict(shape=shape, rows=v.shape[0], segments=plan.n,
                   bound_ms=b_ms, bound_by=b_by, device_ms={},
                   library_device_ms=[])
        for name, k in kernels.items():
            run = with_kernel(k, lambda: SG.segment_sum(plan, v))
            a, b = run(), run()
            same = bool(torch.equal(a, ref) and torch.equal(a, b))
            ok &= same
            row.setdefault("bitwise", {})[name] = same
            row["device_ms"][name] = []
        for _ in range(args.rounds):
            for name in order:
                run = with_kernel(kernels[name],
                                  lambda: SG.segment_sum(plan, v))
                row["device_ms"][name].append(CS.graph_ms(run))
            row["library_device_ms"].append(CS.graph_ms(lib))
        for name, t in row["device_ms"].items():
            print(f"[seg_sum_bench] {shape} {name}: device "
                  f"{min(t):.5f}-{max(t):.5f} ms, index_add_ "
                  f"{min(row['library_device_ms']):.5f}-"
                  f"{max(row['library_device_ms']):.5f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}), bitwise {row['bitwise'][name]}",
                  flush=True)
        rows.append(row)
    edges = {}
    for shape in CS.SEG_EDGES:
        plan, v = CS.seg_case(shape, "cuda")
        ref = SG.segment_sum_ordered(plan, v)
        for name, k in kernels.items():
            run = with_kernel(k, lambda: SG.segment_sum(plan, v))
            a, b = run(), run()
            same = bool(torch.equal(a, ref) and torch.equal(a, b))
            ok &= same
            edges.setdefault(shape, {})[name] = same
    print(f"[seg_sum_bench] edge shapes bitwise: {edges}")
    smi = CS.nvidia_smi_line()
    print(smi)
    summary = dict(card=smi, sources=sources, shapes=rows, edges=edges,
                   ok=ok)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
