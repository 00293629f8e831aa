"""Loop closing on the card by stage and sub-range, eagerly and through
the CUDA graphs.

    python3 scripts/torch_loop_profile.py [--modes eager,graph] [--profile]
                                          [--replays N]

Needs one CUDA card. The constructed-drift arena of ``chip_smoke.py``'s
``loop`` phase (``SlamConfig()``: K=512 x N=2000, L=65536, the repo's
vocabulary) is closed by ``LoopCloser.process`` on slots 12 and 13 at
consistency_th = 1, on a fresh copy each time: for each mode in turn
(``eager``: ``LoopCloser.graphs`` off; ``graph``: the solves' iterations
replayed from CUDA graphs) a cold closure and a warm one, each printed with
its wall ms, stage ms, host reads, eigen-solve waits, graph counts, peak
memory and the sha256 digest of the closed arena (every table, in field
order: bitwise equal closures print the same digest); with ``--profile``
one more closure of each mode under ``torch.profiler``, printed by stage
and by ``chip_smoke.LOOP_SUBRANGES`` (host ms, device busy ms, device
operations, host waits). ``--replays N`` then closes one graph system N
times more, its arena restored in place each time
(``chip_smoke.restore_loop_system``), so that every later closure replays
the system's loop graphs: each printed like a warm closure.

It uses only ``chip_smoke.loop_system``, ``profile_stages``,
``log_profile`` and ``LoopCloser``, so a copy in another checkout's
``scripts/`` runs that checkout's closure (mode ``eager``, without the
sub-ranges where its ``chip_smoke.py`` has none): two checkouts' digests
in one call hold one closure against the other.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from cubemapslam_tpu_torch import SlamConfig  # noqa: E402
from cubemapslam_tpu_torch import place as PL  # noqa: E402
from cubemapslam_tpu_torch.camera import CubemapCamera  # noqa: E402
from cubemapslam_tpu_torch.runtime.loop_closing import \
    LoopCloser  # noqa: E402

# the sub-ranges of the correction and the global BA (none in a checkout
# that predates them)
SUBRANGES = getattr(CS, "LOOP_SUBRANGES", ())


def digest(arena) -> str:
    h = hashlib.sha256()
    for k in arena._fields:
        h.update(k.encode())
        h.update(getattr(arena, k).detach().cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def closer(cfg, mode):
    lc = LoopCloser(cfg, CubemapCamera.from_config(cfg, "cuda"))
    lc.consistency_th = 1
    if mode == "graph" and not hasattr(lc, "graph_counts"):
        raise SystemExit("this checkout's LoopCloser has no graphs")
    lc.graphs = mode == "graph"
    return lc


def counts(lc) -> str:
    g = getattr(lc, "graph_counts", None)
    if g is None:
        return "no graphs"
    return (f"captures {g['captures']}, replays {g['replays']}, capture "
            f"{g['capture_ms']:.3f} ms, pool {g['capture_mib']:.1f} MiB, "
            f"capture waits {lc.capture_waits}")


def closure(cfg, vocab, mode, tag):
    system = CS.loop_system(cfg, "cuda", vocab, CS.LOOP_POINTS, CS.SEED + 7)
    lc = closer(cfg, mode)
    torch.cuda.reset_peak_memory_stats()
    closed = [lc.process(system, 12)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    closed.append(lc.process(system, 13))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    times = {k: [round(x * 1e3, 3) for x in v]
             for k, v in lc.timings.items()}
    print(f"[loop-profile] {mode} {tag}: {closed}; wall {wall:.3f} ms; "
          f"stage wall ms {times}; host reads {lc.reads}, eigen-solve waits "
          f"{lc.eigh_waits}; {counts(lc)}; peak memory {peak:.1f} MiB; "
          f"sha256 {digest(system.arena)}", flush=True)
    if closed != [False, True]:
        raise SystemExit(f"the {mode} closure did not close")
    return wall


def profiled(cfg, vocab, mode, wall):
    system = CS.loop_system(cfg, "cuda", vocab, CS.LOOP_POINTS, CS.SEED + 7)
    lc = closer(cfg, mode)
    lc.process(system, 12)
    prof = CS.profile_stages(lambda: lc.process(system, 13),
                             CS.LOOP_STAGES + SUBRANGES, 1)
    CS.log_profile(f"loop-profile-{mode}", prof, [wall])
    print(f"[loop-profile-{mode}] host reads {lc.reads}, eigen-solve waits "
          f"{lc.eigh_waits}; {counts(lc)}; host waits "
          f"{prof['host_waits']:.0f}", flush=True)


def replayed(cfg, vocab, n):
    """One graph system closed, then ``n`` times more on its restored
    arena."""
    system = CS.loop_system(cfg, "cuda", vocab, CS.LOOP_POINTS, CS.SEED + 7)
    initial, _ = CS.loop_arena_tables(system.arena)
    for i in range(n + 1):
        if i:
            CS.restore_loop_system(system, initial)
        lc = closer(cfg, "graph")
        closed = [lc.process(system, 12)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        closed.append(lc.process(system, 13))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        times = {k: [round(x * 1e3, 3) for x in v]
                 for k, v in lc.timings.items()}
        print(f"[loop-profile] graph closure {i} on one system: {closed}; "
              f"wall {wall:.3f} ms; stage wall ms {times}; host reads "
              f"{lc.reads}; {counts(lc)}; sha256 {digest(system.arena)}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="eager,graph",
                    help="a comma list of eager, graph, run in that order")
    ap.add_argument("--profile", action="store_true",
                    help="also close once in each mode under the profiler")
    ap.add_argument("--replays", type=int, default=0,
                    help="then close one graph system this many times more")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg = SlamConfig()
    vocab = PL.load_vocabulary(str(CS.VOCAB_PATH))
    print(f"[loop-profile] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; checkout {ROOT}", flush=True)
    for mode in args.modes.split(","):
        closure(cfg, vocab, mode, "cold")
        wall = closure(cfg, vocab, mode, "warm")
        if args.profile:
            profiled(cfg, vocab, mode, wall)
    if args.replays:
        replayed(cfg, vocab, args.replays)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
