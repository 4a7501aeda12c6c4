"""The native TSV reader (counterpart of
``empirical_mvm_tpu/data/native_tsv.py``; ref: utils/tsv_file.py:43-111,
dataset.py:136-140).

``native/tsv_reader.cpp`` maps a TSV into memory, finds rows through the
``.lineidx`` sidecar and base64-decodes frame fields on a C++ thread pool,
in place of Python's seek, readline, split and b64decode. It is built with
the host's C++ compiler at first use, never at import, into
``build/libemvm_tsv_<hash>.so`` at the repository root by ``ops/_build.py``
``compile_once``, as the kernels are (the hash covers the compiler's
command and the source; the build lands by an atomic rename), and loaded
with ``ctypes``.

:func:`open_tsv` takes ``reader="native"`` (the default) or
``reader="python"``, the plain version (``data/tsv.py`` ``TSVFile``). A
failed build raises: nothing falls back to Python behind the caller's back.
"""

from __future__ import annotations

import ctypes
import os
import os.path as op
import shutil
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from empirical_mvm_torch.data.tsv import TSVFile, generate_lineidx
from empirical_mvm_torch.ops import _build

SOURCE = Path(__file__).resolve().parent.parent / "native" / "tsv_reader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
READERS = ("native", "python")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _command() -> list[str]:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (c++ or g++) on PATH for the native TSV reader")
    return [cxx, *CXX_FLAGS, str(SOURCE)]


def library_path() -> Path:
    return _build.library_file("emvm_tsv", _command(), [SOURCE])


def build() -> Path:
    """Compile ``native/tsv_reader.cpp`` into ``build/`` unless that build
    is there already; return its path. Raises if no compiler is found or
    the compiler fails."""
    return _build.compile_once("emvm_tsv", _command(), [SOURCE])


def library() -> ctypes.CDLL:
    """The loaded reader library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tsv_open.restype = ctypes.c_void_p
            lib.tsv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.tsv_num_rows.restype = ctypes.c_int64
            lib.tsv_num_rows.argtypes = [ctypes.c_void_p]
            lib.tsv_row_ptr.restype = ctypes.c_void_p
            lib.tsv_row_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_int64)]
            lib.tsv_decode_batch.restype = None
            lib.tsv_decode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32]
            lib.tsv_close.restype = None
            lib.tsv_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class NativeTSVFile:
    """``TSVFile``'s interface on the C++ reader, with batched base64
    decode of (row, field) pairs."""

    def __init__(self, tsv_path: str, lineidx_path: str | None = None):
        self.lib = library()
        self.tsv_path = tsv_path
        lineidx_path = lineidx_path or op.splitext(tsv_path)[0] + ".lineidx"
        self.handle = self.lib.tsv_open(tsv_path.encode(), lineidx_path.encode())
        if not self.handle:
            raise OSError(f"tsv_open failed for {tsv_path}")
        self._tls = threading.local()

    def num_rows(self) -> int:
        return int(self.lib.tsv_num_rows(self.handle))

    def __len__(self) -> int:
        return self.num_rows()

    def row_bytes(self, idx: int) -> bytes:
        n = ctypes.c_int64()
        ptr = self.lib.tsv_row_ptr(self.handle, idx, ctypes.byref(n))
        if not ptr:
            raise IndexError(idx)
        return ctypes.string_at(ptr, n.value)

    def __getitem__(self, idx: int) -> list[str]:
        return self.row_bytes(idx).decode("utf-8").split("\t")

    def get_key(self, idx: int) -> str:
        rb = self.row_bytes(idx)
        tab = rb.find(b"\t")
        return (rb if tab < 0 else rb[:tab]).decode("utf-8")

    def decode_fields(self, pairs: Sequence[tuple[int, int]],
                      max_field_bytes: int = 1 << 20,
                      n_threads: int | None = None) -> list[bytes]:
        """Base64-decode the (row, field) pairs on the C++ thread pool.
        Loader threads call this concurrently, so each thread has its own
        buffer; the results are copied out of it."""
        n = len(pairs)
        if n_threads is None:
            # the loader's threads already work across items; fan out in
            # C++ only where the host has cores to spare
            n_threads = max(1, min((os.cpu_count() or 1) // 2, n))
        rows = (ctypes.c_int64 * n)(*[p[0] for p in pairs])
        fields = (ctypes.c_int32 * n)(*[p[1] for p in pairs])
        need = n * max_field_bytes
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.size < need:
            self._tls.buf = buf = np.empty(need, np.uint8)
        out_lens = (ctypes.c_int64 * n)()
        self.lib.tsv_decode_batch(
            self.handle, rows, fields, n,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            max_field_bytes, out_lens, n_threads)
        out = []
        for i in range(n):
            ln = out_lens[i]
            if ln < 0:
                raise ValueError(f"decode failed for pair {pairs[i]} (code {ln})")
            out.append(buf[i * max_field_bytes: i * max_field_bytes + ln].tobytes())
        return out

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.tsv_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()


def open_tsv(tsv_path: str, reader: str = "native") -> NativeTSVFile | TSVFile:
    """A TSV reader with its ``.lineidx`` sidecar generated if missing:
    :class:`NativeTSVFile` (``reader="native"``) or the plain
    :class:`~empirical_mvm_torch.data.tsv.TSVFile` (``"python"``)."""
    if reader not in READERS:
        raise ValueError(f"reader must be one of {READERS}, not {reader!r}")
    idx_path = op.splitext(tsv_path)[0] + ".lineidx"
    if not op.isfile(idx_path):
        generate_lineidx(tsv_path, idx_path)
    if reader == "native":
        return NativeTSVFile(tsv_path, idx_path)
    return TSVFile(tsv_path)
