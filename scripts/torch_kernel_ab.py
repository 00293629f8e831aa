"""What the benchmarks that compare builds of one kernel on the card share.

``torch_seg_sum_bench.py`` and ``torch_sym_eig_bench.py`` import it: the
``--source`` / ``--rounds`` / ``--out`` options, the builds of each source
with the kernel's own flags (``_build.variant``), a call with the package's
kernel swapped for a build, the A B B A timing rounds and the summary. It
is not run on its own.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from cubemapslam_tpu_torch import _build  # noqa: E402


def options(doc: str) -> argparse.ArgumentParser:
    """The shared options; a script adds its own before parsing."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of a source of the kernel (repeatable)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="timing rounds, each over every source and back")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    return ap


def builds(kernel: _build.CudaKernel, sources: dict, tag: str):
    """Each source of ``sources`` (name -> path) built as ``kernel`` with its
    flags: (name -> kernel, whether every build succeeded). A failed build
    is printed and left out, so the others are still timed."""
    kernels, ok = {}, True
    for name, path in sources.items():
        try:
            kernels[name] = _build.variant(kernel, pathlib.Path(path))
        except RuntimeError as e:
            print(f"[{tag}] {name}: {e}", flush=True)
            ok = False
    return kernels, ok


def swapped(owner, attr: str, kernel, fn):
    """``fn`` as a call that runs with ``owner.<attr>`` (the package's
    kernel) swapped for ``kernel``."""
    def call():
        keep = getattr(owner, attr)
        setattr(owner, attr, kernel)
        try:
            return fn()
        finally:
            setattr(owner, attr, keep)
    return call


def abba(names, rounds: int, time) -> dict:
    """``time(name)`` for every name, in ``rounds`` rounds that each run the
    names in order and then reversed (A B B A ...): name -> its times."""
    names = list(names)
    out = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            out[name].append(time(name))
    return out


def finish(summary: dict, out) -> int:
    """Print the card's name and power limit and the JSON summary (with the
    card), write it to ``out`` if given; 0 if ``summary["ok"]``, else 1."""
    smi = CS.nvidia_smi_line()
    print(smi)
    summary = dict(card=smi, **summary)
    if out:
        pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


def needs_card() -> bool:
    """False, with a message, where no CUDA card is present."""
    if torch.cuda.is_available():
        return True
    print("needs a CUDA card", file=sys.stderr)
    return False
