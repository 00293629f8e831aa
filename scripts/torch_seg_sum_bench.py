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
exits 1 if a build fails or differs from the plain version anywhere.
The options, builds and rounds are ``torch_kernel_ab``'s.
"""

from __future__ import annotations

import sys

import torch

import torch_kernel_ab as AB
from torch_kernel_ab import CS, _build
from cubemapslam_tpu_torch import segment as SG


def main() -> int:
    args = AB.options(__doc__).parse_args()
    if not AB.needs_card():
        return 1
    sources = dict(s.split("=", 1) for s in args.source) or {
        "tree": str(_build.CSRC / "seg_sum.cu")}
    kernels, ok = AB.builds(SG.SEG_SUM, sources, "seg_sum_bench")

    def run(name, plan, v):
        return AB.swapped(SG, "SEG_SUM", kernels[name],
                          lambda: SG.segment_sum(plan, v))

    def bitwise(plan, v):
        ref = SG.segment_sum_ordered(plan, v)
        same = {}
        for name in kernels:
            a, b = run(name, plan, v)(), run(name, plan, v)()
            same[name] = bool(torch.equal(a, ref) and torch.equal(a, b))
        return same

    rows = []
    for shape in CS.SEG_SHAPES:
        plan, v = CS.seg_case(shape, "cuda")
        b_ms, b_by = CS.seg_bound(plan, v)

        def lib(plan=plan, v=v):
            return torch.zeros((plan.n + 1,) + tuple(v.shape[1:]),
                               device="cuda").index_add_(0, plan.idx, v)[:-1]

        row = dict(shape=shape, rows=v.shape[0], segments=plan.n,
                   bound_ms=b_ms, bound_by=b_by, bitwise=bitwise(plan, v))
        ok &= all(row["bitwise"].values())
        row["device_ms"] = AB.abba(
            kernels, args.rounds,
            lambda name: CS.graph_ms(run(name, plan, v)))
        row["library_device_ms"] = [CS.graph_ms(lib)
                                    for _ in range(args.rounds)]
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
        edges[shape] = bitwise(*CS.seg_case(shape, "cuda"))
        ok &= all(edges[shape].values())
    print(f"[seg_sum_bench] edge shapes bitwise: {edges}")
    return AB.finish(dict(sources=sources, shapes=rows, edges=edges, ok=ok),
                     args.out)


if __name__ == "__main__":
    sys.exit(main())
