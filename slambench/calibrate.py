"""The readings that the limits of ``correct`` are set from.

    python3 slambench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] > readings.jsonl

runs the cell once a seed in one process, on the card, and prints a JSON
line a seed with every compared number of

* the program (``sound``): its outputs against the reference;
* the control (``control``): the reference computed a precision below the
  stated one, in the program's place (the extract numbers);
* each fault that the cell can have, planted in the program's outputs:
  ``frozen`` (every window pose the window's first: a step that returns
  its state unchanged), ``altered`` (one window pose, drawn from the seed,
  moved by a tenth of the path's extent and turned by 5 degrees: an
  answer altered where it is produced), ``moved`` (every landmark moved by
  2% of its distance from the keyframes' mean centre in a seeded
  direction: the map's answer altered), ``kf_moved`` (one live keyframe,
  drawn from the seed, moved by a tenth of the keyframes' extent),
  ``dropped`` (one valid keypoint in ten of every sampled frame made
  invalid: keypoints lost where they are produced), and,
  for a cell whose map must stay frozen, none, since any change there
  reads above its limit of 0.

The benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _faults(out, traffic, fields, seed, want, device):
    import numpy as np

    from slambench.reference import judge as J
    from slambench.reference import trajectory as T
    rng = np.random.default_rng([seed, 2])
    res = {}
    p = list(out.poses)
    if len(p) >= 3:
        first = p[0]
        frozen = [(f, first[1], first[2]) for f, _, _ in p]
        res["frozen"] = J.numbers(out._replace(poses=frozen, kps=[]),
                                  traffic, fields, want=want)
        i = int(rng.integers(len(p)))
        gt = T.centres(np.stack([traffic.poses[f][0] for f, _, _ in p]),
                       np.stack([traffic.poses[f][1] for f, _, _ in p]))
        f, R, t = p[i]
        est = T.centres(np.stack([q[1] for q in p]),
                        np.stack([q[2] for q in p]))
        scale = (np.linalg.norm(est.max(0) - est.min(0))
                 / max(np.linalg.norm(gt.max(0) - gt.min(0)), 1e-9))
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        a = np.radians(5.0)
        dR = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
        c = -R.T @ t + 0.1 * scale * np.linalg.norm(gt.max(0) - gt.min(0)) \
            * axis
        R2 = dR @ R
        p[i] = (f, R2, -R2 @ c)
        res["altered"] = J.numbers(out._replace(poses=p, kps=[]), traffic,
                                   fields, want=want)
    kps = []
    for f, kp in out.kps:
        v = np.array(kp["valid"], bool)
        v[np.nonzero(v)[0][::10]] = False
        kps.append((f, dict(kp, valid=v)))
    res["dropped"] = J.numbers(out._replace(kps=kps, poses=[]), traffic,
                               fields, want=want, device=device)
    a = dict(out.arena)
    live = np.nonzero(a["kf_valid"])[0]
    if len(live):
        ctr = T.centres(a["kf_R"][live], a["kf_t"][live]).mean(0)
        d = rng.normal(size=a["lm_pos"].shape)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        a["lm_pos"] = a["lm_pos"] + 0.02 * np.linalg.norm(
            a["lm_pos"] - ctr, axis=1, keepdims=True) * d
        res["moved"] = J.numbers(out._replace(arena=a, kps=[]), traffic,
                                 fields, want=want)
        a = dict(out.arena)
        c = T.centres(a["kf_R"][live], a["kf_t"][live])
        k = int(live[rng.integers(len(live))])
        d = rng.normal(size=3)
        t = a["kf_t"].copy()
        t[k] = t[k] - a["kf_R"][k] @ (0.1 * np.linalg.norm(
            c.max(0) - c.min(0)) * d / np.linalg.norm(d))
        a["kf_t"] = t
        res["kf_moved"] = J.numbers(out._replace(arena=a, kps=[]), traffic,
                                    fields, want=want)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import harness
    from slambench.reference import judge as J
    want = set(harness.Cell(args.workload).workload["limits"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False,
                          device=args.device, keep_outputs=True)
        out, traffic, fields = res.pop("_outputs")
        line = {"seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "sound": J.numbers(out, traffic, fields, want=want,
                                   device=args.device),
                "control": J.numbers(out, traffic, fields, "control",
                                     want=want, device=args.device)}
        line.update(_faults(out, traffic, fields, seed, want, args.device))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
