"""Build and load the port's CUDA kernels.

Each kernel package holds one ``kernel.cu`` with a plain C interface. At
first use it is compiled by ``nvcc`` into a shared library under
``build/repro_torch_kernels/`` in the checkout (git-ignored), named by a
hash of its sources and flags so that an edit rebuilds, and loaded with
``ctypes``. No PyTorch headers are compiled, so a build takes seconds.
``build_all`` starts one ``nvcc`` per source at once.

A library that fails to build raises; nothing falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.obs import trace as _trace

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
PACKAGES = ("bfs_multi_step", "bfs_pull_step", "bfs_step", "edge_update",
            "label_join")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _sources(name: str) -> list[Path]:
    """The package's kernel.cu plus every shared header under kernels/."""
    return [KERNELS_DIR / name / "kernel.cu"] + sorted(
        KERNELS_DIR.rglob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    (process, temp path, final path) or None."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(KERNELS_DIR / name / "kernel.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    so.with_suffix(".log").write_text(out)
    os.replace(tmp, so)


def build_all(names=PACKAGES) -> dict[str, Path]:
    """Compile every named kernel library, one nvcc per source, all started
    together. Returns name -> library path."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            _finish(n, s)
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def launch(name: str, fn: str, device, *args) -> None:
    """Call launcher ``fn`` of kernel package ``name`` on ``device``'s
    current stream. ``args`` are tensors (passed as device pointers) and
    Python ints (passed as C ints); the stream is appended. Raises on a
    CUDA error. The launch does not synchronize. ``None`` passes a null
    pointer (an output the launcher is told not to write). Traced as one
    ``kernel.launch`` span around the C call: the host's enqueue."""
    lib = load(name)
    cfn = getattr(lib, fn)
    cfn.argtypes = [ctypes.c_int if isinstance(a, int) else ctypes.c_void_p
                    for a in args] + [ctypes.c_void_p]
    cfn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        vals = [a if isinstance(a, int) or a is None else a.data_ptr()
                for a in args]
        with _trace.span("kernel.launch", package=name, fn=fn):
            code = cfn(*vals, stream)
        check(lib, code, f"{name}.{fn}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise on a tensor a launcher does not take: wrong dtype, shape or
    device, or not contiguous."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype}{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device} "
                         f"(got {t.device}, contiguous={t.is_contiguous()})")
