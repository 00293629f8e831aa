"""The benchmark's files: every configuration, cell and metric file loads,
BENCHMARK.json names only what exists and keeps to its contract, and a
cell or a metric added as files of its own is found without an edit."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_names_only_what_exists():
    from slambench import harness
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["slambench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.workload["config"] == w["config"] in configs
        assert cell.workload["traffic"] == w["traffic"]
        assert (BENCH / "traffic" / f"{w['traffic']}.py").is_file()
        assert w["chips"] == 1
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "fps", "frame_ms.p95"} <= e2e
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in b["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, f"layer {layer!r} not in PERF.md"


def test_every_cell_file_loads_with_limits():
    from slambench import harness
    for p in sorted((BENCH / "workloads").glob("*.json")):
        cell = harness.Cell(p.stem)
        assert cell.workload["limits"], p
        assert cell.workload["trace_frames"] > 0
        for key in ("n_features", "cube_face_w", "scale_factor",
                    "ini_th_fast", "min_th_fast", "poly", "inv_poly"):
            assert key in cell.fields


def test_run_without_a_card_prints_nothing(tmp_path):
    """No CUDA card: non-zero exit and no result line, also in a directory
    that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "slambench/run.py", "--workload",
             "lafida_loc.patrol", "--seed", str(2 ** 31 + 5), "--seconds",
             "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert p.returncode != 0
        assert p.stdout.strip() == ""


def test_added_files_are_found_without_an_edit(tmp_path):
    """A cell and a metric added as files of their own in a copy of the
    benchmark are found by name; nothing that was there is edited."""
    dst = tmp_path / "slambench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    w = json.loads((dst / "workloads" / "lafida_loc.patrol.json")
                   .read_text())
    w["params"]["lateral_offset"] = 0.04
    (dst / "workloads" / "lafida_loc.wide.json").write_text(
        json.dumps(w))
    (dst / "metrics" / "track.frames.py").write_text(
        "def read(tw):\n    return tw.n or None\n")
    b["workloads"].append({"name": "lafida_loc.wide",
                           "config": "lafida_loc", "traffic": "patrol",
                           "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "track.frames", "unit": "frames",
                           "better": "higher", "source": "program_span",
                           "layer": "tracking", "moves": "fps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from slambench import harness\n"
        "c = harness.Cell('lafida_loc.wide')\n"
        "assert c.params['lateral_offset'] == 0.04\n"
        "class TW: n = 3\n"
        "got = harness.read_per_layer('lafida_loc.wide', TW)\n"
        "assert got['track.frames']['value'] == 3.0, got\n" % str(tmp_path))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=tmp_path,
                   timeout=300)


@pytest.mark.parametrize("module", ["slambench.reference.judge",
                                    "slambench.reference.extract",
                                    "slambench.reference.trajectory",
                                    "slambench.traffic.world"])
def test_reference_imports_nothing_of_the_program(module):
    """The reference and the traffic load neither JAX, the JAX package nor
    the port, judged by whole top-level names."""
    code = ("import sys; sys.path.insert(0, %r); import %s\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'cubemapslam_tpu', "
            "'cubemapslam_tpu_torch'})\n"
            "assert not bad, bad\n" % (str(ROOT), module))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_run_imports_no_jax():
    """What run.py loads on the card, the port included, has no module whose
    top-level name is jax, jaxlib, flax or the JAX package's (the port's
    name starts with the JAX package's, so names are compared whole)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch.profiler\n"
        "from slambench import harness, calibrate\n"
        "from slambench.measure import window\n"
        "import cubemapslam_tpu_torch.runtime.system\n"
        "import cubemapslam_tpu_torch.config\n"
        "import importlib, pathlib\n"
        "for p in pathlib.Path(%r).glob('traffic/*.py'):\n"
        "    importlib.import_module('slambench.traffic.' + p.stem)\n"
        "for m in harness.benchmark()['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "assert 'cubemapslam_tpu_torch' in sys.modules\n"
        "assert not harness.forbidden_modules(), "
        "harness.forbidden_modules()\n" % (str(ROOT), str(BENCH)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
