"""Cost of one ``all_reduce`` of the sharded global BA's tables on a card.

    python3 scripts/torch_allreduce_cost.py [--reps 200]

Needs one CUDA card. Times ``torch.distributed.all_reduce`` of float32 CUDA
tensors of the shapes the sharded BA reduces on the full-width loop arena
(``chip_smoke.py``'s ``dist`` phase): the (512, 6) camera table, a
(4096, 3) boundary prefix and the whole (65536, 3) point table. Once at
world size 1 over NCCL in this process, then at world size 2 over gloo in
two spawned ranks that share the card (gloo stages CUDA tensors through
the host). Each time is the mean over ``--reps`` calls after 5 warm-up
calls, the card synchronised before and after. Prints one JSON line per
configuration and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cubemapslam_tpu_torch import dist as D  # noqa: E402

SHAPES = ((512, 6), (4096, 3), (65536, 3))


def time_all_reduce(group, reps: int) -> dict:
    """{shape: mean ms of one all_reduce} on this rank's card."""
    out = {}
    for shape in SHAPES:
        x = torch.ones(shape, device="cuda")
        for _ in range(5):
            dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        out["x".join(map(str, shape))] = (time.perf_counter() - t0) \
            / reps * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{d}/store", 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", 0))
        try:
            nccl = time_all_reduce(dist.group.WORLD, args.reps)
        finally:
            dist.destroy_process_group()
    print(json.dumps({"world_size": 1, "backend": "nccl",
                      "all_reduce_ms": nccl}))
    ranks = D.run_ranks(time_all_reduce, 2, args=(args.reps,), timeout=600)
    print(json.dumps({"world_size": 2, "backend": "gloo",
                      "all_reduce_ms_by_rank": ranks}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
