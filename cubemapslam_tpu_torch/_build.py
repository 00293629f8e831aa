"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points (``extern "C"``), one
per ``__global__`` kernel, that take device pointers, sizes and a
``cudaStream_t`` and return ``cudaGetLastError()`` after launching. It is
compiled at first use by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries a hash of the source, and loaded
with ``ctypes``. No PyTorch header is compiled, so a build takes seconds.

``csrc/graph_census.cu`` is the one source that launches no kernel: its
``capture_ops`` counts a capture's device operations (``capture_ops``).

There is no fallback: a missing ``nvcc``, a failed build or a non-zero launch
status raises. ``--use_fast_math`` is deliberately not passed, so divisions
and square roots round as IEEE float32, like the plain PyTorch versions.
``SOURCE_FLAGS`` adds flags for one source (``-fmad=false`` where every
product and sum must round on its own, as the plain version's do).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" \
    / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCE_FLAGS: Dict[str, Sequence[str]] = {"pose_lm.cu": ("-fmad=false",),
                                          "sym_eig.cu": ("-fmad=false",),
                                          "triangulate.cu": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _flags(source: str) -> List[str]:
    return [*NVCC_FLAGS, *SOURCE_FLAGS.get(source, ())]


def _lib_path(source: str) -> pathlib.Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(source)).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build_all(sources: Iterable[str]) -> Dict[str, str]:
    """Compile every listed source that is not built yet, one ``nvcc`` per
    source, all started together. Returns {source: compiler output} for the
    sources compiled by this call; raises if any build fails."""
    todo = [s for s in dict.fromkeys(sources) if not _lib_path(s).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in todo:
        out = _lib_path(s)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *_flags(s), "-o", str(tmp), str(CSRC / s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for s, out, tmp, p in procs:
        log, _ = p.communicate()
        logs[s] = log
        if p.returncode != 0:
            failed.append(f"{s} (rc {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build_all([source])
        lib = ctypes.CDLL(str(_lib_path(source)))
        _LIBS[source] = lib
    return lib


class CudaKernel:
    """One C entry point of one CUDA source, with its launch counter.

    Each entry point launches exactly one ``__global__`` kernel. ``argtypes``
    lists the ctypes of the arguments before the trailing stream; pointers
    are ``ctypes.c_void_p``. ``launches`` counts the calls that launched the
    kernel; it is a plain integer that callers may reset. A call made while
    a CUDA graph is captured launches nothing: whoever captures takes its
    count back and adds it on each replay (``runtime/fused_step.py``).
    ``CudaKernel.instances`` lists every entry point made.
    """

    instances: List["CudaKernel"] = []

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes: List[type] = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None
        CudaKernel.instances.append(self)

    def build(self) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn

    def __call__(self, *args) -> None:
        self.build()
        stream = torch.cuda.current_stream().cuda_stream
        self.launches += 1
        status = self._fn(*args, stream)
        if status != 0:
            raise RuntimeError(f"{self.symbol} ({self.source}) launch failed: "
                               f"cudaError {status}")


def variant(kernel: CudaKernel, path: pathlib.Path) -> CudaKernel:
    """``kernel``'s entry point built from another source ``path`` (a
    variant or a parent commit's version, for a benchmark that compares
    them on one card) with ``kernel``'s flags, into ``BUILD_DIR``: a new
    ``CudaKernel`` with its own launch counter. Raises if nvcc fails."""
    flags = _flags(kernel.source)
    digest = hashlib.sha256(path.read_bytes() + " ".join(flags).encode())
    lib = BUILD_DIR / f"variant_{path.stem}_{digest.hexdigest()[:12]}.so"
    if not lib.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_nvcc(), *flags, "-o", str(lib), str(path)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{done.stdout}"
                               f"{done.stderr}")
    k = CudaKernel(path.name, kernel.symbol, kernel.argtypes[:-1])
    fn = getattr(ctypes.CDLL(str(lib)), k.symbol)
    fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    k._fn = fn
    return k


def capture_ops(stream: torch.cuda.Stream) -> int:
    """The device operations (kernel, memcpy and memset nodes) captured so
    far into the CUDA graph that ``stream`` is capturing
    (``csrc/graph_census.cu``, which launches nothing). Raises when the
    stream is not capturing or the runtime refuses the query."""
    fn = load("graph_census.cu").capture_ops
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = ctypes.c_longlong(0)
    status = fn(stream.cuda_stream, ctypes.byref(out))
    if status != 0:
        raise RuntimeError(f"capture_ops: status {status} (-1: the stream "
                           f"is not capturing, else a cudaError)")
    return out.value


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check that every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev} "
                             f"(got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


@contextlib.contextmanager
def cusolver(dev: torch.device):
    """``torch.linalg`` on cuSOLVER (and cuBLAS's batched LU) while the
    block runs, on the card: routes that a CUDA graph can capture and that
    read nothing back to the host (``solve_ex`` / ``inv_ex`` check no
    error flag)."""
    if dev.type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)
