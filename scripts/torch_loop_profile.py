"""Loop closing on the card by stage and sub-range, eagerly and through
the CUDA graphs.

    python3 scripts/torch_loop_profile.py [--modes eager,graph] [--profile]
                                          [--replays N] [--trace] [--grow]

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
the system's loop graphs: each printed like a warm closure, then the
median and spread of each stage's wall over the N replaying closures.
With ``--trace`` the same system is then closed N times more, each
closure under ``torch.profiler``: its stages by host ms, device busy ms,
device operations and host waits, and the CUDA runtime calls the host
made inside ``loop.gba`` (a graph capture's ``cudaMalloc`` /
``cudaGraphInstantiate``, a synchronisation), summed by name, the six
longest: what a slow global BA spends its wall on.

``--grow`` then runs the global BA (``LoopCloser._global_ba``) of one
more graph system on its arena, restored in place each time, with the
observations of only its first n keyframes live, n rising
from 4 to all 14 (a map that grows between closures, about 1,440 live
observations a keyframe), then all 14 again and 12: each solve printed
with its live count, edge capacity, the graphs it captured and replayed,
its capture ms, the wall, the capacities held and the pool's and the
card's reserved MiB: what a closure pays when the map grew since the
last one, and whether the pool stays bounded.

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
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

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


def stage_trace(prof, stage: str, top: int = 6):
    """``stage``'s ranges in ``prof``: (host ms, device busy ms and
    operations of what they launched, the CUDA API calls (``cu*``) the
    host made inside them as (name, (ms, count)) summed by name, the
    ``top`` longest)."""
    events = CS.raw_events(prof)
    cpu = [e for e in events if not e[1]]
    spans = [(e[2], e[3]) for e in cpu if e[0] == stage]
    inside = CS.launched_in([e for e in events if e[1]],
                            CS.launch_times(cpu), spans)
    by_name = {}
    for name, _, a, b, *_ in cpu:
        if name.startswith("cu") and any(s <= a < e for s, e in spans):
            ms, c = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + (b - a) / 1e6, c + 1)
    return (sum(b - a for a, b in spans) / 1e6,
            sum(k[3] - k[2] for k in inside) / 1e6, len(inside),
            sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top])


def replayed(cfg, vocab, n, trace):
    """One graph system closed, then ``n`` times more on its restored
    arena (and ``n`` more under the profiler with ``trace``)."""
    system = CS.loop_system(cfg, "cuda", vocab, CS.LOOP_POINTS, CS.SEED + 7)
    initial, _ = CS.loop_arena_tables(system.arena)
    stages = {}
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
        if i:
            stages.setdefault("closure", []).append(wall)
            for k, v in times.items():
                stages.setdefault(k, []).append(v[-1])
    for k, v in stages.items():
        med = statistics.median(v)
        print(f"[loop-profile] {n} replaying closures, {k}: median "
              f"{med:.3f} ms, {min(v):.3f}-{max(v):.3f}; over twice the "
              f"median: {[i + 1 for i, x in enumerate(v) if x > 2 * med]}",
              flush=True)
    if not trace:
        return
    for i in range(n):
        CS.restore_loop_system(system, initial)
        lc = closer(cfg, "graph")
        lc.process(system, 12)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lc.process(system, 13)
            torch.cuda.synchronize()
        host, busy, ops, calls = stage_trace(prof, "loop.gba")
        gba = lc.timings["gba"][-1] * 1e3
        calls = ", ".join(f"{name} {ms:.3f} ms x{c}"
                          for name, (ms, c) in calls)
        print(f"[loop-trace] replaying closure {i + 1} under the profiler: "
              f"gba wall {gba:.3f} ms, host {host:.3f} ms, device busy "
              f"{busy:.3f} ms in {ops} operations; {counts(lc)}; runtime "
              f"calls in loop.gba: {calls}", flush=True)


def grown(cfg, vocab):
    """The global BA of one closed graph system over a growing map (see
    the module docstring)."""
    from cubemapslam_tpu_torch import dist as D
    system = CS.loop_system(cfg, "cuda", vocab, CS.LOOP_POINTS, CS.SEED + 7)
    lc = closer(cfg, "graph")
    initial, _ = CS.loop_arena_tables(system.arena)
    obs = system.arena.kf_obs_lm
    walls = {}
    for n in [*range(4, 15), 14, 12]:
        CS.restore_loop_system(system, initial)
        obs[n:].fill_(-1)
        count = int(D.global_ba_problem_from_arena(
            lc.cam, system.arena, lc.k.inv_level_sigma2).obs_valid.sum())
        lc = closer(cfg, "graph")
        fg = getattr(system.fused_loop_for(lc.k), "global_ba", None)
        before = (fg.captures, fg.replays, fg.capture_ms) if fg else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc._global_ba(system)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if fg is not None:
            cap = lc.k.ba_edge_capacity(count, obs.numel())
            made = (f"capacity {cap}, captures {fg.captures - before[0]}, "
                    f"replays {fg.replays - before[1]}, capture "
                    f"{fg.capture_ms - before[2]:.3f} ms; capacities held "
                    f"{fg.capacities}, pool {fg.capture_mib:.1f} MiB")
        else:
            made = counts(lc)
        kind = ("a solve's own graphs" if fg is None else "a new capacity"
                if fg.captures > before[0] else "a held capacity")
        walls.setdefault(kind, []).append(wall)
        print(f"[loop-grow] {n} keyframes live, {count} live observations: "
              f"gba wall {wall:.3f} ms; {made}; card reserved "
              f"{torch.cuda.memory_reserved() / 2 ** 20:.1f} MiB", flush=True)
    for k, v in walls.items():
        print(f"[loop-grow] solves with {k}: {len(v)}, wall median "
              f"{statistics.median(v):.3f} ms, {min(v):.3f}-{max(v):.3f}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="eager,graph",
                    help="a comma list of eager, graph, run in that order "
                         "(empty: none)")
    ap.add_argument("--profile", action="store_true",
                    help="also close once in each mode under the profiler")
    ap.add_argument("--replays", type=int, default=0,
                    help="then close one graph system this many times more")
    ap.add_argument("--trace", action="store_true",
                    help="then as many more under the profiler, with the "
                         "host's CUDA calls in loop.gba")
    ap.add_argument("--grow", action="store_true",
                    help="then the global BA of one system over a growing "
                         "map")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg = SlamConfig()
    vocab = PL.load_vocabulary(str(CS.VOCAB_PATH))
    print(f"[loop-profile] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; checkout {ROOT}", flush=True)
    for mode in filter(None, args.modes.split(",")):
        closure(cfg, vocab, mode, "cold")
        wall = closure(cfg, vocab, mode, "warm")
        if args.profile:
            profiled(cfg, vocab, mode, wall)
    if args.replays:
        replayed(cfg, vocab, args.replays, args.trace)
    if args.grow:
        grown(cfg, vocab)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
