"""Time builds of the eigen-solve kernel against ``torch.linalg.eigh``.

    python3 scripts/torch_sym_eig_bench.py [--source NAME=PATH ...]
                                           [--other NAME ...] [--rounds 2]
                                           [--out JSON]

Builds each source (by default the package's ``csrc/sym_eig.cu``) with the
package's ``nvcc`` flags for that file into ``build/torch_kernels/``; each
must expose ``sym_eig_launch`` with the package's C signature, so versions
of the kernel (a working copy, a variant, a parent commit's) can be
compared within one call on one card. On the six eigen-solve inputs of one
``pnp_ransac`` on a seeded scene (``chip_smoke.pnp_eig_inputs``) it checks
each build against ``sym_eig.sym_eig_ordered`` and times its device ms from
a CUDA graph (``chip_smoke.graph_ms``) in rounds that run the sources in
the given order and then reversed (A B B A ...), beside
``torch.linalg.eigh``'s ms (``chip_smoke.time_ms``: it waits for the host
each call, so no graph holds it); for each source whose program is the
plain version's it also times one step (``chip_smoke.eig_step_ms``). A
source named by ``--other`` runs another program (say the parent's cyclic
order): its bits are reported, not required, and it has no step time.
Prints one line a solve and source, the card's name and power limit, and a
JSON summary (also written to ``--out``); exits 1 if a build that should
be bitwise fails or differs from the plain version. The options, builds
and rounds are ``torch_kernel_ab``'s.
"""

from __future__ import annotations

import sys

import torch

import torch_kernel_ab as AB
from torch_kernel_ab import CS, _build
from cubemapslam_tpu_torch.solvers import sym_eig as SE


def main() -> int:
    ap = AB.options(__doc__)
    ap.add_argument("--other", action="append", default=[],
                    help="NAME of a source that runs another program")
    args = ap.parse_args()
    if not AB.needs_card():
        return 1
    sources = dict(s.split("=", 1) for s in args.source) or {
        "package": str(_build.CSRC / "sym_eig.cu")}
    kernels, ok = AB.builds(SE.SYM_EIG, sources, "sym_eig_bench")

    def run(name, fn):
        return AB.swapped(SE, "SYM_EIG", kernels[name], fn)

    rows = []
    for site, A in zip(CS.EIG_SITES, CS.pnp_eig_inputs("cuda")):
        A = A.reshape(-1, *A.shape[-2:]).contiguous()
        ref_w, ref_V, _, sw, st = SE.sym_eig_ordered(A, counts=True)
        row = dict(site=site, shape=list(A.shape), max_sweeps=int(sw.max()),
                   max_steps=int(st.max()), bitwise={})
        for name in kernels:
            w, V = run(name, lambda: SE.sym_eig_cuda(A))()
            same = CS.same_float_bits(w, ref_w) and \
                CS.same_float_bits(V, ref_V)
            row["bitwise"][name] = same
            ok &= same or name in args.other
        row["device_ms"] = AB.abba(
            kernels, args.rounds,
            lambda name: CS.graph_ms(run(name, lambda: SE.sym_eig_cuda(A))))
        row["library_ms"] = [CS.time_ms(lambda: torch.linalg.eigh(A))
                             for _ in range(args.rounds)]
        lib = row["library_ms"]
        for name, t in row["device_ms"].items():
            print(f"[sym_eig_bench] {site} {tuple(A.shape)} {name}: device "
                  f"{min(t):.5f}-{max(t):.5f} ms, eigh {min(lib):.5f}-"
                  f"{max(lib):.5f} ms; bitwise {row['bitwise'][name]}; "
                  f"{row['max_steps']} steps ({row['max_sweeps']} sweeps) "
                  f"in the slowest matrix", flush=True)
        rows.append(row)
    steps = {}
    for name in kernels:
        if name in args.other:
            continue
        for n in SE.SYM_EIG_SIZES:
            step_ms, count = run(name, lambda: CS.eig_step_ms(n))()
            steps.setdefault(name, {})[n] = step_ms
            print(f"[sym_eig_bench] {name}: one step at n={n} "
                  f"{step_ms * 1e3:.4f} us ({count} steps)", flush=True)
    return AB.finish(dict(sources=sources, other=args.other, solves=rows,
                          step_ms=steps, ok=ok), args.out)


if __name__ == "__main__":
    sys.exit(main())
