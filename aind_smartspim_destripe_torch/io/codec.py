"""
Build and bind the native blosc-zstd runtime of the port's own codec.

:mod:`.blosc` encodes and decodes chunk frames through a native library
built from this package's ``csrc/destripe_runtime.cpp`` (a copy of the JAX
package's codec source) and otherwise through the ``zstandard`` module. A
host can have the zstd runtime library without its header, and no
``zstandard``. So the source is built here against ``libzstd.so.1`` and the
zstd declarations of ``csrc/zstd_shim/zstd.h``, with the JAX package's
Makefile flags, into ``build/torch_kernels/`` (next to the CUDA kernels),
once per source and host CPU, at first use. The frames are byte-identical
to the JAX package's encoder (tests/test_torch_pipeline.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..ops.cuda_build import build_dir
from . import blosc

__all__ = ["ensure_native_codec", "build_shim_codec", "load_native_codec"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SRC = _CSRC / "destripe_runtime.cpp"
_SHIM = _CSRC / "zstd_shim"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def _host_cpu() -> bytes:
    """The CPU model and flags (``-march=native`` code runs only there)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep))).encode()


def build_shim_codec() -> Path:
    """Build the native blosc runtime against the zstd declarations shim
    (once per source and host CPU) and return the library's path. Raises
    RuntimeError with the compiler's message when g++ fails or is absent."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _host_cpu())
    for src in (_SRC, _SHIM / "zstd.h"):
        digest.update(src.read_bytes())
    out = build_dir() / f"libdestripe_runtime_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    if shutil.which("g++") is None:
        raise RuntimeError("cannot build the blosc runtime: g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-I", str(_SHIM), str(_SRC), "-o", str(tmp),
           "-l:libzstd.so.1", "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ could not build the blosc runtime (exit {res.returncode}):"
            "\n" + res.stderr[-4000:]
        )
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/destripe_runtime.cpp``."""
    ll, sz = ctypes.c_longlong, ctypes.c_size_t
    pp = ctypes.POINTER(ctypes.c_char_p)
    i = ctypes.c_int
    sigs = {
        "blosc1_compress": (ll, [ctypes.c_char_p, sz, i, i, i,
                                 ctypes.c_char_p, sz]),
        "blosc1_decompress": (ll, [ctypes.c_char_p, sz, ctypes.c_char_p, sz]),
        "blosc1_compress_batch": (i, [i, pp, ctypes.POINTER(sz), i, i, i, pp,
                                      ctypes.POINTER(sz), ctypes.POINTER(ll),
                                      i]),
        "blosc1_decompress_batch": (i, [i, pp, ctypes.POINTER(sz), pp,
                                        ctypes.POINTER(sz),
                                        ctypes.POINTER(ll), i]),
        "blosc1_compress_slab": (i, [ctypes.c_void_p, ll, ll, ll, ll, ll,
                                     i, i, i, i, i, i, ctypes.c_ulonglong,
                                     pp, ctypes.POINTER(sz),
                                     ctypes.POINTER(ll), i]),
        "blosc1_decompress_slab": (i, [pp, ctypes.POINTER(sz),
                                       ctypes.c_void_p, ll, ll, ll, ll, ll,
                                       i, i, i, i, ctypes.c_ulonglong, i]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load_native_codec():
    """The bound native runtime, built here first when needed; False where
    there is no g++ (:mod:`.blosc` then uses ``zstandard``). Raises
    RuntimeError, with the compiler's message, when the build fails."""
    if shutil.which("g++") is None:
        return False
    return _bind(ctypes.CDLL(str(build_shim_codec())))


def ensure_native_codec() -> str:
    """Make the blosc-zstd encoder of :mod:`.blosc` ready and name its
    backend: 'native-shim' (the native runtime built here) or
    'zstandard'."""
    return "native-shim" if blosc._load_native() else "zstandard"
