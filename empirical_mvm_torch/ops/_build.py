"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper), all
sources at once in parallel, and linked into one shared library with a
plain C interface under ``build/`` at the repository root. The library's
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one is loaded as it is; :func:`compile_once` builds
the data layer's two native libraries the same way. The build runs at first use,
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
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

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
    "emvm_layer_norm_bwd_smem_bytes": ((_I, _I), _SZ),
    "emvm_direct_window_attention_fwd": (
        (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P), _I),
    "emvm_direct_window_attention_bwd": (
        (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P), _I),
    "emvm_direct_window_attention_bwd_scratch": ((_I, _I, _I, _I, _I, _I, _I, _I), _LL),
    "emvm_direct_window_attention_bwd_smem_bytes": ((_I, _I, _I), _SZ),
    "emvm_direct_window_attention_bwd_onchip": ((_I,), _I),
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


def library_file(stem: str, command: Sequence[str], sources: Sequence[Path]) -> Path:
    """``build/lib{stem}_<hash>.so``: the hash covers ``command`` (the
    compiler, its flags and library dirs, all but the output path) and each
    source's name and bytes, so a change to any of them builds anew."""
    h = hashlib.sha256("\0".join(command).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def compile_once(stem: str, command: Sequence[str], sources: Sequence[Path],
                 make: Callable[[Path, Path], None] | None = None) -> Path:
    """Build a shared library into ``build/`` unless the build of this
    ``command`` and ``sources`` is there (:func:`library_file`); return its
    path. ``make(out, tmp)`` writes the library to ``out``, with ``tmp`` a
    private scratch directory; by default it runs ``command -o out`` and
    raises with the compiler's output if that fails. The library lands by
    an atomic rename, so a concurrent build sees all of it or none."""
    so = library_file(stem, command, sources)
    if so.exists():
        return so
    tmp = BUILD_DIR / f"tmp_{so.stem}_{os.getpid()}_{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        out = tmp / so.name
        if make is not None:
            make(out, tmp)
        else:
            res = subprocess.run([*command, "-o", str(out)], capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"building {', '.join(p.name for p in sources)} failed:\n"
                                   f"{res.stdout}{res.stderr}")
        os.replace(out, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def library_path(csrc: Path | None = None) -> Path:
    return library_file("emvm_kernels", NVCC_FLAGS, _sources(csrc))


def build(verbose: bool = False, csrc: Path | None = None) -> Path:
    """Compile every .cu of ``csrc`` (default: the package's csrc/) in
    parallel and link them into one .so; return its path. ``verbose`` adds
    ``-Xptxas -v`` and prints what nvcc says (registers, shared memory and
    spills of each kernel)."""
    sources = _sources(csrc)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])

    def make(out: Path, tmp: Path) -> None:
        nvcc = _nvcc()
        procs = []
        for src in sources:
            if src.suffix != ".cu":
                continue
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
            if verbose and log:
                print(log, flush=True)
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(out),
                              *(str(o) for _, o, _ in procs)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")

    return compile_once("emvm_kernels", NVCC_FLAGS, sources, make)


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
    """The current stream's handle on ``device``, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it, without
    building a Stream object (the raw query the compiled code of
    torch.compile makes before each launch)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(device: torch.device):
    """``torch.cuda.device(device)``, or no guard where ``device`` is the
    current device already (the guard costs about 2 us of host time a
    launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
