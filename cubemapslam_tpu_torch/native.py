"""Host image IO and the host warp plan: ctypes bindings of the port's
native C++ loader (``csrc/dataloader.cpp``).

Counterpart of ``cubemapslam_tpu/native.py``: a worker-pool prefetching
image loader with ordered delivery (PNG, JPEG and binary PGM, decoded to
float32 luma), the PIL loader that stands in for it, and ``NativeWarp``,
the bilinear fisheye -> cubemap plan applied on the host.

The library is built at first use with ``g++`` from the port's copy of the
loader, ``csrc/dataloader.cpp`` (the repo's ``native/dataloader.cpp`` with
each codec behind a define), into ``build/native/`` at the root of the
checkout (listed in ``.gitignore``), under a name that carries a hash of the
source and the flags. It is built with PNG and JPEG where libpng and
libjpeg are installed, else with binary PGM only, whose loader reports a PNG
or JPEG file as a decode failure (the app then decodes it with PIL). It is
built for the host's generic instruction set: the binary committed under
``native/_build/`` was built with ``-march=native`` on another host and is
never loaded here. This is host IO; the frame path on the card (kernel W,
``warp_cuda.py``) does not use ``NativeWarp``, and the CPU path keeps
``warp.warp_bilinear``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import pathlib
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cubemapslam_tpu_torch.warp import WarpMap, bilinear_operands

log = logging.getLogger(__name__)

_ROOT = pathlib.Path(__file__).resolve().parent
SOURCE = _ROOT / "csrc" / "dataloader.cpp"
BUILD_DIR = _ROOT.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# the variants tried in order: every codec, then binary PGM alone
CODECS = (("-DDL_WITH_PNG", "-DDL_WITH_JPEG", "-lpng", "-ljpeg"), ())

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "dl_create": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]),
    "dl_next": (ctypes.c_int, [ctypes.c_void_p, _INTP, _INTP]),
    "dl_copy": (None, [ctypes.c_void_p, _F32P]),
    "dl_destroy": (None, [ctypes.c_void_p]),
    "wp_create": (ctypes.c_void_p, [_I32P, _F32P, ctypes.c_int,
                                    ctypes.c_int]),
    "wp_apply": (None, [ctypes.c_void_p, _F32P, _F32P, ctypes.c_int]),
    "wp_apply_u8": (None, [ctypes.c_void_p, _F32P, _U8P, ctypes.c_int]),
    "wp_destroy": (None, [ctypes.c_void_p]),
}


def library_path(codecs: Tuple[str, ...]) -> pathlib.Path:
    """Where the library of the current source, flags and codecs is
    built."""
    digest = hashlib.sha256(
        SOURCE.read_bytes()
        + " ".join(GXX_FLAGS + codecs).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcubemap_dataloader_{digest}.so"


def build(codecs: Tuple[str, ...]) -> Optional[str]:
    """Build one variant (an entry of ``CODECS``) if it is not built yet.
    Returns its path, or None when ``g++`` or a codec library is missing or
    the build fails."""
    out = library_path(codecs)
    if out.is_file():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    defines = [c for c in codecs if c.startswith("-D")]
    libs = [c for c in codecs if c.startswith("-l")]
    cmd = ["g++", *GXX_FLAGS, *defines, str(SOURCE), "-o", str(tmp), *libs,
           "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log.info("dataloader variant %s did not build: %s", codecs,
                 getattr(e, "stderr", b"") or e)
        return None
    os.replace(tmp, out)
    return str(out)


@functools.lru_cache(maxsize=None)
def load_library(codecs: Tuple[str, ...]) -> Optional[ctypes.CDLL]:
    """One variant, built first if needed, with its C signatures; None when
    it does not build or does not load (a codec library missing at run
    time)."""
    so = build(codecs)
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        log.info("dataloader variant %s did not load: %s", codecs, e)
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load_lib() -> Optional[ctypes.CDLL]:
    """The first variant of ``CODECS`` that builds here."""
    for codecs in CODECS:
        lib = load_library(codecs)
        if lib is not None:
            return lib
    return None


class NativeImageLoader:
    """Ordered prefetching grayscale loader over the native worker pool.
    Iterating yields (index, (H, W) float32 image), or (index, None) for a
    file that did not decode."""

    def __init__(self, paths: List[str], n_workers: int = 4,
                 queue_cap: int = 8):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native dataloader unavailable")
        self._lib = lib
        # the C side keeps these pointers until dl_destroy
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.dl_create(arr, len(self._paths), n_workers,
                                     queue_cap)
        self._n = len(paths)
        self._served = 0

    def __iter__(self) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
        return self

    def __next__(self) -> Tuple[int, Optional[np.ndarray]]:
        if self._handle is None or self._served >= self._n:
            raise StopIteration
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.dl_next(self._handle, ctypes.byref(w),
                               ctypes.byref(h))
        idx = self._served
        self._served += 1
        if rc == 0:
            raise StopIteration
        if rc < 0:
            return idx, None
        out = np.empty((h.value, w.value), np.float32)
        self._lib.dl_copy(self._handle, out.ctypes.data_as(_F32P))
        return idx, out

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class FallbackImageLoader:
    """Synchronous PIL loader with the same iterator interface."""

    def __init__(self, paths: List[str], **_):
        self._paths = paths
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[int, Optional[np.ndarray]]:
        if self._i >= len(self._paths):
            raise StopIteration
        from PIL import Image, UnidentifiedImageError
        idx = self._i
        self._i += 1
        try:
            with Image.open(self._paths[idx]) as im:
                img = np.asarray(im.convert("L"), np.float32)
        except (OSError, UnidentifiedImageError, ValueError):
            return idx, None
        return idx, img

    def close(self) -> None:
        pass


def make_loader(paths: List[str], n_workers: int = 4, queue_cap: int = 8):
    """The native loader, else the PIL one; logs which it took and raises
    when neither can decode."""
    try:
        loader = NativeImageLoader(paths, n_workers, queue_cap)
    except (RuntimeError, OSError) as e:
        try:
            import PIL  # noqa: F401
        except ImportError:
            raise RuntimeError(
                f"no image loader: the native one is unavailable ({e}) and "
                "PIL is not installed") from None
        loader = FallbackImageLoader(paths)
    log.info("image loader: %s", type(loader).__name__)
    return loader


class NativeWarp:
    """Host fisheye -> cubemap warp over the precomputed bilinear plan of a
    ``WarpMap`` (the reference's cv::remap, as the JAX package's CPU path
    runs it), with ``faces()`` for the (5, FH, FW) uint8 face stack."""

    # cross layout: face i -> (x, y) cell offsets in face units
    # (front, left, right, upper, lower)
    FACE_CELLS = ((1, 1), (0, 1), (2, 1), (1, 0), (1, 2))

    def __init__(self, warp_map: WarpMap, n_threads: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native warp unavailable")
        self._lib = lib
        idx00, w = bilinear_operands(warp_map)
        idx2 = idx00.cpu().numpy().astype(np.int32)
        w2 = w.cpu().numpy().astype(np.float32)
        self._shape = idx2.shape
        self._src_wh = tuple(warp_map.src_wh)
        self._n_threads = n_threads
        H, W = self._shape
        fh, fw = H // 3, W // 3
        self._face_hw = (fh, fw)
        # the C plans keep pointers into these arrays
        self._idx = np.ascontiguousarray(idx2.reshape(-1))
        self._w = np.ascontiguousarray(w2.reshape(-1))
        self._plan = lib.wp_create(self._idx.ctypes.data_as(_I32P),
                                   self._w.ctypes.data_as(_F32P),
                                   self._idx.size, self._src_wh[0])
        # face-packed plan: only the 5 cross cells, in face order
        self._fidx = np.ascontiguousarray(np.concatenate([
            idx2[cy * fh:(cy + 1) * fh, cx * fw:(cx + 1) * fw].reshape(-1)
            for cx, cy in self.FACE_CELLS]))
        self._fw = np.ascontiguousarray(np.concatenate([
            w2[cy * fh:(cy + 1) * fh, cx * fw:(cx + 1) * fw].reshape(-1, 4)
            for cx, cy in self.FACE_CELLS]).reshape(-1))
        self._face_plan = lib.wp_create(self._fidx.ctypes.data_as(_I32P),
                                        self._fw.ctypes.data_as(_F32P),
                                        self._fidx.size, self._src_wh[0])

    def _source(self, fisheye: np.ndarray) -> np.ndarray:
        src = np.ascontiguousarray(fisheye, np.float32)
        W, H = self._src_wh
        if src.shape != (H, W):
            raise ValueError(f"fisheye must be ({H}, {W}), got {src.shape}")
        return src

    def __call__(self, fisheye: np.ndarray) -> np.ndarray:
        """(H, W) fisheye -> (Hc, Wc) float32 cross."""
        src = self._source(fisheye)
        out = np.empty(self._shape, np.float32)
        self._lib.wp_apply(self._plan, src.ctypes.data_as(_F32P),
                           out.ctypes.data_as(_F32P), self._n_threads)
        return out

    def faces(self, fisheye: np.ndarray) -> np.ndarray:
        """(H, W) fisheye -> (5, FH, FW) uint8 faces (front, left, right,
        upper, lower), skipping the cross's dead corners."""
        src = self._source(fisheye)
        fh, fw = self._face_hw
        out = np.empty((5, fh, fw), np.uint8)
        self._lib.wp_apply_u8(self._face_plan, src.ctypes.data_as(_F32P),
                              out.ctypes.data_as(_U8P), self._n_threads)
        return out

    def close(self) -> None:
        for name in ("_plan", "_face_plan"):
            plan = getattr(self, name, None)
            if plan is not None:
                self._lib.wp_destroy(plan)
                setattr(self, name, None)

    def __del__(self):
        self.close()
