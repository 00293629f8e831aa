"""Whole runs: a tiny cell added as a file of its own in a copy of the
benchmark runs on the CPU through the plain versions (the control flow of
a run, from set-up to the result line), its check holds, and it comes out
not correct with the timed path broken underneath; and, marked ``gpu``, a
short run of each cell on the card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2 ** 31 + 12345
# the tiny cell: 160 px faces, 600 features and two 63-frame laps, so that
# the plain versions run it on the CPU; its limits are its own
TINY = {"cfg.cube_face_w": 160, "cfg.cube_face_h": 160,
        "cfg.n_features": 600, "radius": 1.5, "step": 0.15,
        "billboards": 300, "laps": 2, "warmup_frames": 8}
TINY_LIMITS = {"kp_set": 0.02, "uv_off": 0.1, "desc_bits": 2.0,
               "angle_off": 0.1, "resp_off": 0.1, "ate_max_pct": 30.0,
               "rot_max_deg": 10.0, "kf_ate_max_pct": 30.0,
               "reproj_p90_px": 10.0, "map_changed": 0}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A copy of the benchmark with the tiny cell added beside the others;
    the program and its vocabulary are linked in."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for name in ("cubemapslam_tpu_torch", "artifacts"):
        os.symlink(ROOT / name, root / name)
    w = json.loads((BENCH / "workloads" / "lafida_loc.patrol.json")
                   .read_text())
    w["limits"] = TINY_LIMITS
    (root / "slambench" / "workloads" / "lafida_loc.tiny.json").write_text(
        json.dumps(w))
    return root


def _run(root, fault=None):
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from slambench import harness\n"
        "res = harness.run('lafida_loc.tiny', %d, 8.0, False, "
        "device='cpu', overrides=%r, fault=%r)\n"
        "print(json.dumps(res))\n" % (str(root), SEED, TINY, fault))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=900,
                       check=True)
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_tiny_cell_runs_on_the_cpu(copy):
    res = _run(copy)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"fps", "frame_ms.p95", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["check"]) == set(TINY_LIMITS)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", ["frozen", "altered", "dropped"])
def test_broken_timed_path_is_not_correct(copy, fault):
    res = _run(copy, fault)
    assert res["correct"] is False, res["check"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["lafida_loc.patrol"])
def test_cell_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
