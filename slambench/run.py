"""The benchmark of cubemapslam_tpu_torch: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. Builds (or
finds built) the port's kernels, renders the cell's frames from the seed,
brings the system to the cell's starting state, drives
``CubemapSLAM.track_fisheye`` for ``--seconds``, checks what it produced
against the plain reference, and prints one JSON line last: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled window. Without a CUDA card, or with the
JAX package loaded, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "slambench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    from slambench import harness
    chips = next((w["chips"] for w in harness.benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA card(s); the "
              f"benchmark does not run on the CPU", file=sys.stderr)
        return 2
    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"slambench: the JAX package or JAX is loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in res["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
