"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper), all
sources at once in parallel, and linked into one shared library with a
plain C interface under ``build/`` at the repository root. The library's
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one is loaded as it is. The build runs at first use,
never at import. The library is loaded with ``ctypes``: every pointer and
the stream pass as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which :func:`record_launch` turns into an
exception.

``launch_counts`` counts kernel launches by wrapper name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels. A backward entry point that runs a second, small
kernel (a fixed-order sum of per-block partials, or the columns half of an
attention backward) counts as one launch.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts: collections.Counter = collections.Counter()

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U, _SZ = ctypes.c_uint, ctypes.c_size_t
_SIGNATURES = {
    # name: (argtypes, restype)
    "emvm_layer_norm_fwd": ((_I, _P, _P, _P, _P, _LL, _I, _F, _P), _I),
    "emvm_layer_norm_bwd": ((_I, _P, _P, _P, _P, _P, _P, _LL, _I, _F, _P), _I),
    "emvm_layer_norm_bwd_scratch": ((_LL, _I), _LL),
    "emvm_direct_window_attention_fwd": (
        (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P), _I),
    "emvm_direct_window_attention_bwd": (
        (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P), _I),
    "emvm_direct_window_attention_bwd_scratch": ((_I, _I, _I, _I, _I, _I, _I), _LL),
    "emvm_direct_window_attention_bwd_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_lane_self_attention_fwd": (
        (_I, _P, _P, _LL, _LL, _P, _I, _I, _I, _I, _F, _P, _U, _F, _P), _I),
    "emvm_lane_self_attention_bwd": (
        (_I, _P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _U, _F, _P), _I),
    "emvm_lane_self_attention_fwd_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_lane_self_attention_bwd_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_lane_window_attention_fwd": (
        (_I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P), _I),
    "emvm_lane_attention_fwd": ((_I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P), _I),
    "emvm_lane_window_attention_bwd": (
        (_I, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _F, _P), _I),
    "emvm_lane_window_attention_bwd_scratch": ((_LL, _I, _I, _I), _LL),
    "emvm_lane_window_attention_bwd_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_packed_window_attention_fwd": (
        (_I, _P, _P, _P, _LL, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P), _I),
    "emvm_packed_window_attention_bwd": (
        (_I, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _F,
         _P), _I),
    "emvm_packed_window_attention_bwd_scratch": ((_LL, _I, _I, _I), _LL),
    "emvm_packed_window_attention_bwd_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_tiled_self_attention_fwd": (
        (_I, _P, _P, _P, _LL, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _F, _P, _U, _F, _P), _I),
    "emvm_tiled_self_attention_bwd": (
        (_I, _P, _P, _P, _P, _P, _P, _LL, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P,
         _U, _F, _P), _I),
    "emvm_tiled_self_attention_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_attention_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_window_attention_fwd_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_error_string": ((_I,), ctypes.c_char_p),
}

# dynamic shared memory one block may opt into on the H100 (227 KB)
MAX_SMEM_BYTES = 232448


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin: "
                           "the port's CUDA kernels need the CUDA toolkit")
    return nvcc


def _sources(csrc: Path | None = None) -> list[Path]:
    return sorted(p for p in (csrc or CSRC).iterdir() if p.suffix in (".cu", ".cuh"))


def library_path(csrc: Path | None = None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libemvm_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, csrc: Path | None = None) -> Path:
    """Compile every .cu of ``csrc`` (default: the package's csrc/) in
    parallel and link them into one .so; return its path. ``verbose`` adds
    ``-Xptxas -v`` and prints what nvcc says (registers, shared memory and
    spills of each kernel)."""
    csrc = csrc or CSRC
    so = library_path(csrc)
    if so.exists():
        return so
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp_{so.stem}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    try:
        procs = []
        for src in _sources(csrc):
            if src.suffix != ".cu":
                continue
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            if verbose and out:
                print(out, flush=True)
        link = tmp / so.name
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(link),
                              *(str(o) for _, o, _ in procs)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(link, so)      # atomic: a concurrent build sees all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load(path: Path, complete: bool = True) -> ctypes.CDLL:
    """Load a built library and declare its entry points' signatures. With
    ``complete`` every entry point of ``_SIGNATURES`` must be there;
    without, those missing are skipped (a build of older sources)."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name) if complete else getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def record_launch(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error, else count a launch."""
    if code:
        msg = library().emvm_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed ({code}): {msg}")
    launch_counts[name] += 1


def check_tensors(*tensors: torch.Tensor) -> torch.device:
    """Common checks of a wrapper's tensors before a launch: all on one CUDA
    device, contiguous. Returns the device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CPU or CUDA tensors, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_smem(nbytes: int, what: str) -> None:
    """Refuse a launch whose block would need more shared memory than one
    H100 block may have."""
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory, above "
                         f"{MAX_SMEM_BYTES}")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return DTYPE_CODES[dtype]
