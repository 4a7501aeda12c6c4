"""JPEG frames to RGB uint8 (counterpart of
``empirical_mvm_tpu/data/transforms.py`` ``decode_raw_image`` :32 and
``decode_b64_image`` :49; ref: dataset.py:136-140).

On the card, :class:`NvJpegDecoder` decodes each frame's host bitstream
with nvJPEG straight into a device buffer (``csrc/jpeg_decode.cpp``, built
by nvcc at first use into its own library under ``build/`` and loaded with
``ctypes``; a failed build raises). On the CPU the caller passes a decode
function (:class:`HostDecoder`): the tests pass ``cv2.imdecode``, as the
JAX package decodes; no CPU decoder is ever chosen here.

Either decoder returns, for each frame, a uint8 (h, w, 3) tensor on its
device, or None where the frame failed (a bad header, a size other than
its header promised, a failed decode): the loader then marks that item
``corrupt``, as the JAX package's ``except`` does. :func:`jpeg_size` reads
a frame's size from its SOF header on the host, for the transform plan.
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from empirical_mvm_torch.ops import _build

SOURCE = _build.CSRC / "jpeg_decode.cpp"

# start-of-frame markers (baseline, extended, progressive, lossless,
# arithmetic); C4, C8 and CC are DHT, JPG and DAC
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_STANDALONE = frozenset([0x01, *range(0xD0, 0xD8)])

#: frames decoded on the card (a count of frames, not of kernels: nvJPEG
#: launches its own)
decode_counts = {"nvjpeg_frames": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def jpeg_size(data: bytes) -> tuple[int, int] | None:
    """(height, width) from the SOF header of a JPEG bitstream, or None if
    the stream does not start a JPEG or reaches its scan without a frame
    header."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    i, n = 2, len(data)
    while i + 1 < n:
        if data[i] != 0xFF:
            return None
        while i + 1 < n and data[i + 1] == 0xFF:      # fill bytes
            i += 1
        if i + 1 >= n:
            return None
        marker = data[i + 1]
        i += 2
        if marker in _STANDALONE:
            continue
        if marker in (0xD9, 0xDA) or i + 2 > n:
            return None
        length = (data[i] << 8) | data[i + 1]
        if marker in _SOF:
            if i + 7 > n:
                return None
            h = (data[i + 3] << 8) | data[i + 4]
            w = (data[i + 5] << 8) | data[i + 6]
            return (h, w) if h and w else None
        i += length
    return None


class HostDecoder:
    """Decode on the CPU with the caller's ``fn(bytes) -> RGB uint8 (h, w,
    3) array``; ``fn`` returning None or raising fails that frame."""

    def __init__(self, fn: Callable[[bytes], np.ndarray | None]):
        self.fn = fn

    def decode(self, frames: Sequence[bytes],
               sizes: Sequence[tuple[int, int]]) -> list[torch.Tensor | None]:
        out = []
        for data, size in zip(frames, sizes):
            try:
                arr = self.fn(data)
            except Exception:  # noqa: BLE001 — a frame that fails marks its item corrupt
                arr = None
            if arr is None or tuple(arr.shape) != (*size, 3):
                out.append(None)
            else:
                out.append(torch.from_numpy(np.ascontiguousarray(arr, np.uint8)))
        return out


def _toolkit_lib_dirs(nvcc: str) -> list[str]:
    root = Path(nvcc).resolve().parent.parent
    dirs = [root / "lib64", *sorted(root.glob("targets/*/lib"))]
    return [str(d) for d in dirs if glob.glob(str(d / "libnvjpeg.so*"))]


def nvjpeg_libraries() -> list[str]:
    """The toolkit's ``libnvjpeg.so*`` files the binding links against."""
    return sorted({os.path.basename(p) for d in _toolkit_lib_dirs(_build._nvcc())
                   for p in glob.glob(os.path.join(d, "libnvjpeg.so*"))})


def _command() -> list[str]:
    """nvcc's command for the binding, linked against the toolkit's nvJPEG
    with an rpath to it. Raises if the toolkit has no nvJPEG."""
    nvcc = _build._nvcc()
    lib_dirs = _toolkit_lib_dirs(nvcc)
    if not lib_dirs:
        raise RuntimeError(f"no libnvjpeg.so* beside {nvcc}: the card's JPEG decode "
                           "needs the CUDA toolkit's nvJPEG")
    return [nvcc, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", str(SOURCE),
            *(f"-L{d}" for d in lib_dirs), "-lnvjpeg",
            *(f"-Xlinker=-rpath,{d}" for d in lib_dirs)]


def library_path() -> Path:
    return _build.library_file("emvm_jpeg", _command(), [SOURCE])


def build() -> Path:
    """Compile ``csrc/jpeg_decode.cpp`` against nvJPEG into ``build/``
    unless that build is there; return its path. Raises if the toolkit
    has no nvJPEG or nvcc fails."""
    return _build.compile_once("emvm_jpeg", _command(), [SOURCE])


def library() -> ctypes.CDLL:
    """The loaded nvJPEG binding, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.emvm_jpeg_create.argtypes = [ctypes.POINTER(P)]
            lib.emvm_jpeg_state_create.argtypes = [P, ctypes.POINTER(P)]
            lib.emvm_jpeg_state_destroy.argtypes = [P]
            lib.emvm_jpeg_destroy.argtypes = [P]
            lib.emvm_jpeg_decode_batch.argtypes = [
                P, P, I, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(I), ctypes.POINTER(I), P]
            for fn in (lib.emvm_jpeg_create, lib.emvm_jpeg_state_create,
                       lib.emvm_jpeg_state_destroy, lib.emvm_jpeg_destroy,
                       lib.emvm_jpeg_decode_batch):
                fn.restype = I
            _lib = lib
    return _lib


class NvJpegDecoder:
    """nvJPEG on ``device``: frames decode on the current CUDA stream into
    tensors allocated there. One nvJPEG handle; one decoder state for each
    thread that calls :meth:`decode`."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"nvJPEG decodes on a CUDA device, not {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.lib = library()
        handle = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            self._check(self.lib.emvm_jpeg_create(ctypes.byref(handle)), "nvjpegCreateSimple")
        self.handle = handle
        self._tls = threading.local()
        self._states: list[ctypes.c_void_p] = []

    @staticmethod
    def _check(code: int, what: str) -> None:
        if code:
            raise RuntimeError(f"{what} failed with status {code}")

    def _state(self) -> ctypes.c_void_p:
        st = getattr(self._tls, "state", None)
        if st is None:
            st = ctypes.c_void_p()
            self._check(self.lib.emvm_jpeg_state_create(self.handle, ctypes.byref(st)),
                        "nvjpegJpegStateCreate")
            self._tls.state = st
            with _lock:
                self._states.append(st)
        return st

    def decode(self, frames: Sequence[bytes],
               sizes: Sequence[tuple[int, int]]) -> list[torch.Tensor | None]:
        """Each frame of planned (h, w) -> uint8 (h, w, 3) on the card, or
        None where it failed."""
        n = len(frames)
        if n == 0:
            return []
        offsets = np.cumsum([0] + [h * w * 3 for h, w in sizes])
        with torch.cuda.device(self.device):
            buf = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=self.device)
            base = buf.data_ptr()
            stream = _build.stream_ptr(self.device)
            status = (ctypes.c_int * n)()
            code = self.lib.emvm_jpeg_decode_batch(
                self.handle, self._state(), n, (ctypes.c_char_p * n)(*frames),
                (ctypes.c_size_t * n)(*[len(f) for f in frames]),
                (ctypes.c_void_p * n)(*[base + int(o) for o in offsets[:-1]]),
                (ctypes.c_int * n)(*[h for h, _ in sizes]),
                (ctypes.c_int * n)(*[w for _, w in sizes]), status, stream)
        if code:
            raise RuntimeError(f"nvJPEG decode: CUDA error {code} after the launches")
        decode_counts["nvjpeg_frames"] += n
        return [None if status[i] else buf[int(offsets[i]):int(offsets[i + 1])]
                .view(sizes[i][0], sizes[i][1], 3) for i in range(n)]

    def close(self) -> None:
        if getattr(self, "handle", None) is None:
            return
        for st in self._states:
            self.lib.emvm_jpeg_state_destroy(st)
        self._states.clear()
        self.lib.emvm_jpeg_destroy(self.handle)
        self.handle = None


def frame_decoder(device, decode: Callable[[bytes], np.ndarray | None] | None = None):
    """The decoder for ``device``: nvJPEG on a CUDA device (``decode`` must
    then be None), the caller's ``decode`` on the CPU (required there)."""
    device = torch.device(device)
    if device.type == "cuda":
        if decode is not None:
            raise ValueError("on a CUDA device the frames decode through nvJPEG; "
                             "pass no decode function")
        return NvJpegDecoder(device)
    if decode is None:
        raise ValueError(f"decoding on {device} needs a decode function from the caller "
                         "(for example one built on cv2.imdecode)")
    return HostDecoder(decode)
