"""
Build, load and launch the port's CUDA kernels.

The CUDA sources in ``csrc/`` of this package (``band.cu``: K1-K4,
``hist.cu``: the Otsu histogram and tail, ``notch.cu``: row medians (masked and
plain), the notch tails (dense, exact-rank and chirp-z) and the per-plane
notch product, ``blend.cu``: the
dual-band blend, ``dense.cu``: the dense levels' fixed-order products;
``notch.cu`` and ``dense.cu`` share the GEMM tile of ``gemm_f32.cuh``,
``band.cu`` and ``blend.cu`` the uint16 epilogues of ``epilogue.cuh``) are
compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ``ctypes``. The build happens at first use, into
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name keyed by the content of the sources and
headers (:func:`digest_inputs`), so an edited file never loads a stale
library. Nothing here runs at import time: the CPU tests import this module
on hosts without ``nvcc``.

The wrappers of ``cuda_band``, ``cuda_hist``, ``cuda_notch``,
``cuda_blend`` and ``cuda_dense`` dispatch with :func:`on_cuda`, validate
with :func:`check` and launch with :func:`launch`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from ..runtime.tracing import span

__all__ = ["kernel_library", "build_dir", "find_nvcc", "SOURCES",
           "digest_inputs", "on_cuda", "check", "launch", "sm_count"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = tuple(CSRC / name for name in ("band.cu", "hist.cu", "notch.cu",
                                         "blend.cu", "dense.cu"))
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_FLAGS = (_ARCH, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def find_nvcc() -> Optional[str]:
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda, or None."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    return next((c for c in cands if c and os.path.exists(c)), None)


_SIGNATURES = {
    "destripe_k1": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    "destripe_k2": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "destripe_k3": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "destripe_k4": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    "destripe_hist": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "destripe_abs_range": [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "destripe_otsu_tail": [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "destripe_row_median": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "destripe_row_median_batch": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "destripe_notch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "destripe_notch_select": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "destripe_notch_project": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "destripe_notch_synth": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "destripe_notch_fft": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "destripe_blend": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "destripe_div17_check": [ctypes.c_uint] + [ctypes.c_void_p] * 3,
    "destripe_dense_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def digest_inputs() -> tuple:
    """The files the library's name is keyed by: the sources and every
    header beside them (``gemm_f32.cuh``, which ``notch.cu`` and
    ``dense.cu`` include; ``epilogue.cuh``, which ``band.cu`` and
    ``blend.cu`` include), so an edited header never loads a stale
    library."""
    return SOURCES + tuple(sorted(CSRC.glob("*.cuh")))


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The compiled kernel library (built on first call). Raises
    RuntimeError when ``nvcc`` is missing or the build fails, with the
    compiler's message. ``kernel_library.build_seconds`` records the build
    (0.0 when a built library was reused) and ``.build_log`` the compiler's
    output of the build that made the library (kept beside it, so a reused
    library still reports its registers and spills). The first call is the
    span ``kernels.load``, with ``built`` and ``build_seconds``."""
    with span("kernels.load") as meta:
        lib = _load_library()
        if meta is not None:
            meta["built"] = kernel_library.build_seconds > 0
            meta["build_seconds"] = kernel_library.build_seconds
        return lib


def _load_library() -> ctypes.CDLL:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in digest_inputs():
        digest.update(src.name.encode() + src.read_bytes())
    out = build_dir() / f"libdestripe_kernels_{digest.hexdigest()[:16]}.so"
    log_file = out.with_suffix(".log")
    kernel_library.build_seconds = 0.0
    kernel_library.build_log = (log_file.read_text() if log_file.exists()
                                else "")
    if not out.exists():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "cannot build the CUDA kernels: nvcc not found (looked in "
                "$CUDA_HOME/bin, PATH and /usr/local/cuda/bin)"
            )
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs = [out.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
        tmp = out.with_name(f"{tag}.so.tmp")
        t0 = time.perf_counter()
        procs = [
            (src.name, subprocess.Popen(
                [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in zip(SOURCES, objs)
        ]
        try:
            steps = [(name, p.communicate(timeout=900)[0], p.returncode)
                     for name, p in procs]
        finally:  # leave no compiler running after a timeout
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(rc == 0 for _, _, rc in steps):
            res = subprocess.run(
                [nvcc, _ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True, timeout=300)
            steps.append(("link", res.stdout + res.stderr, res.returncode))
        for obj in objs:
            obj.unlink(missing_ok=True)
        kernel_library.build_seconds = time.perf_counter() - t0
        kernel_library.build_log = "".join(log for _, log, _ in steps)
        failed = [(name, rc, log) for name, log, rc in steps if rc != 0]
        if failed:
            name, rc, log = failed[0]
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {rc}):\n" + log[-8000:])
        log_file.write_text(kernel_library.build_log)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.destripe_cuda_error_string.argtypes = [ctypes.c_int]
    lib.destripe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for tensors on {t.device}")


def check(name: str, t: torch.Tensor, dtypes, device, shape=None) -> None:
    """Raise unless ``t`` has one of ``dtypes``, lies on ``device``, is
    contiguous and (when given) has ``shape``."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of card ``index``, which the
    persistent and grid-filling launches size their grids from."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(fn: str, device: torch.device, *args) -> None:
    """Call the C entry ``fn`` with ``args`` and the current stream of
    ``device``; raises RuntimeError when it reports a CUDA error."""
    lib = kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.destripe_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} ({msg})")
