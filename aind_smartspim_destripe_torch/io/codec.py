"""
The blosc-zstd chunk codec the output stores are written with.

The port writes its stores through the reference package's JAX-free
``aind_smartspim_destripe_tpu.io`` modules. Their codec (``io/blosc.py``)
prefers the native runtime ``csrc/libdestripe_runtime.so`` (built from
``csrc/destripe_runtime.cpp`` by ``make -C csrc``) and otherwise the
``zstandard`` module. A host can have neither: the zstd runtime library
without its header, and no ``zstandard``. :func:`ensure_native_codec` then
builds the same source, with the reference Makefile's flags, into this
package's build directory (``build/torch_kernels/``, next to the CUDA
kernels), against ``libzstd.so.1`` and the zstd declarations of
``csrc/zstd_shim/zstd.h``, and installs it as the reference codec's native
library. That install sets the reference module's ``_native`` handle: the
one private name of the reference package the port relies on. The store
format and its bytes do not change (tests/test_torch_pipeline.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from aind_smartspim_destripe_tpu.io import blosc as _blosc

from ..ops.cuda_build import build_dir

__all__ = ["ensure_native_codec", "build_shim_codec"]

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "destripe_runtime.cpp"
_SHIM = Path(__file__).resolve().parents[1] / "csrc" / "zstd_shim"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
_shim = None  # the library ensure_native_codec installed, once it has


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
    """Declare the C signatures of ``csrc/destripe_runtime.cpp``, as the
    reference codec's loader does."""
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


def ensure_native_codec() -> str:
    """Make a blosc-zstd encoder available and name it: 'native' (the
    reference package's own build), 'native-shim' (built here against the
    zstd declarations shim, wherever g++ is) or 'zstandard'. Raises
    RuntimeError, with the compiler's message, when the build fails."""
    global _shim
    if _shim is not None and _blosc._native is _shim:
        return "native-shim"
    if _blosc._load_native():
        return "native"
    if shutil.which("g++") is None and _blosc._zstd is not None:
        return "zstandard"
    _shim = _blosc._native = _bind(ctypes.CDLL(str(build_shim_codec())))
    return "native-shim"
