"""
Minimal Zarr v2 store (directory backend), replacing the reference's
zarr-python dependency (zarr_destriper.py:1062-1074 creates the output store;
the input SmartSPIM tiles are OME-Zarr v2 directories).

Supports what the pipeline needs, bit-compatibly with zarr-python:
- ``.zarray`` / ``.zgroup`` / ``.zattrs`` JSON metadata,
- C-order chunks, "/" or "." dimension separators,
- blosc (zstd, via the native codec in io/blosc.py), zlib, or raw chunks,
- full-chunk padding at array edges (zarr v2 stores whole chunks),
- numpy-style casting on assignment (float -> uint16 truncates like the
  reference's ``output_destriped_zarr[...] = float_data``,
  zarr_destriper.py:336),
- thread-pooled chunk encode/decode (the native codec drops the GIL).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib as _zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from . import blosc as _blosc

__all__ = ["BloscCodec", "ZlibCodec", "ZarrArray", "ZarrGroup", "open_zarr", "group"]

_pool = ThreadPoolExecutor(max_workers=min(32, (os.cpu_count() or 4)))


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


class BloscCodec:
    def __init__(self, cname="zstd", clevel=3, shuffle=_blosc.SHUFFLE, blocksize=0):
        self.cname = cname
        self.clevel = clevel
        self.shuffle = shuffle
        self.blocksize = blocksize

    @property
    def config(self):
        return {
            "id": "blosc",
            "cname": self.cname,
            "clevel": self.clevel,
            "shuffle": self.shuffle,
            "blocksize": self.blocksize,
        }

    @property
    def can_encode(self) -> bool:
        # decode handles every stock c-blosc cname; ENCODE is zstd-only
        # (io/blosc.compress raises otherwise) — resume gates query this
        # instead of re-deriving the rule from the config dict
        return self.cname == "zstd"

    def encode(self, data: bytes, typesize: int) -> bytes:
        return _blosc.compress(
            data, typesize, clevel=self.clevel, shuffle=self.shuffle,
            cname=self.cname, blocksize=self.blocksize,
        )

    def decode(self, data: bytes) -> bytes:
        return _blosc.decompress(data)

    def encode_batch(self, datas: list, typesize: int) -> list:
        """Many chunks in one native call (C++ thread fan-out, no per-chunk
        Python dispatch); the slab writes of the streaming pipeline hit this."""
        return _blosc.compress_batch(
            datas, typesize, clevel=self.clevel, shuffle=self.shuffle,
            cname=self.cname,
        )

    def decode_batch(self, frames: list) -> list:
        return _blosc.decompress_batch(frames)

    def encode_slab(self, arr, chunks, fill_value):
        """Whole chunk grid of a strided 3-D slab in one native call (the
        gather copy fuses with the encode — see blosc.compress_slab);
        None -> caller falls back to the per-chunk path."""
        if self.cname != "zstd":
            return None
        return _blosc.compress_slab(
            arr, chunks, clevel=self.clevel, shuffle=self.shuffle,
            fill_value=fill_value,
        )

    def decode_slab(self, frames, out, chunks, fill_value) -> bool:
        return _blosc.decompress_slab(frames, out, chunks, fill_value=fill_value)


class ZlibCodec:
    def __init__(self, level=1):
        self.level = level

    @property
    def config(self):
        return {"id": "zlib", "level": self.level}

    def encode(self, data: bytes, typesize: int) -> bytes:
        return _zlib.compress(data, self.level)

    def decode(self, data: bytes) -> bytes:
        return _zlib.decompress(data)


class GzipCodec:
    def __init__(self, level=1):
        self.level = level

    @property
    def config(self):
        return {"id": "gzip", "level": self.level}

    def encode(self, data: bytes, typesize: int) -> bytes:
        import gzip as _gzip

        return _gzip.compress(data, self.level)

    def decode(self, data: bytes) -> bytes:
        import gzip as _gzip

        return _gzip.decompress(data)


class ZstdCodec:
    """numcodecs 'zstd' (bare zstd frames, no blosc container)."""

    def __init__(self, level=1):
        self.level = level

    @property
    def config(self):
        return {"id": "zstd", "level": self.level}

    def encode(self, data: bytes, typesize: int) -> bytes:
        import zstandard

        return zstandard.ZstdCompressor(level=self.level).compress(data)

    def decode(self, data: bytes) -> bytes:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)


class RawCodec:
    config = None

    def encode(self, data: bytes, typesize: int) -> bytes:
        return data

    def decode(self, data: bytes) -> bytes:
        return data


def codec_from_config(cfg: Optional[dict]):
    if cfg is None:
        return RawCodec()
    cid = cfg.get("id")
    if cid == "blosc":
        return BloscCodec(
            cname=cfg.get("cname", "zstd"),
            clevel=cfg.get("clevel", 3),
            shuffle=cfg.get("shuffle", _blosc.SHUFFLE),
            blocksize=cfg.get("blocksize", 0),
        )
    if cid == "zlib":
        return ZlibCodec(level=cfg.get("level", 1))
    if cid == "gzip":
        return GzipCodec(level=cfg.get("level", 1))
    if cid == "zstd":
        return ZstdCodec(level=cfg.get("level", 1))
    raise NotImplementedError(f"compressor {cid!r} not supported")


# ---------------------------------------------------------------------------
# Filters (numcodecs array-to-array transforms, applied before the
# compressor on encode — foreign OME-Zarr inputs use these; the reference
# read such stores through zarr-python, zarr_destriper.py:1027-1035)
# ---------------------------------------------------------------------------


class DeltaFilter:
    def __init__(self, dtype, astype=None):
        self.dtype = np.dtype(dtype)
        self.astype = np.dtype(astype) if astype else self.dtype

    def encode(self, arr: np.ndarray) -> np.ndarray:
        arr = arr.astype(self.dtype, copy=False).ravel()
        out = np.empty_like(arr, dtype=self.astype)
        out[0] = arr[0]
        out[1:] = np.diff(arr)
        return out

    def decode(self, arr: np.ndarray) -> np.ndarray:
        return np.cumsum(arr.ravel(), dtype=self.dtype)

    @property
    def encoded_dtype(self):
        return self.astype


class ShuffleFilter:
    """numcodecs 'shuffle': byte transpose over the whole buffer."""

    def __init__(self, elementsize: int):
        self.elementsize = int(elementsize)

    def encode(self, arr: np.ndarray) -> np.ndarray:
        raw = np.frombuffer(arr.tobytes(), np.uint8)
        from . import blosc as _b

        return np.frombuffer(_b.byte_shuffle(raw, self.elementsize), np.uint8)

    def decode(self, arr: np.ndarray) -> np.ndarray:
        from . import blosc as _b

        raw = arr.view(np.uint8) if arr.dtype == np.uint8 else np.frombuffer(arr.tobytes(), np.uint8)
        return np.frombuffer(_b.byte_unshuffle(raw.tobytes(), self.elementsize), np.uint8)

    @property
    def encoded_dtype(self):
        return np.dtype(np.uint8)


class AsTypeFilter:
    def __init__(self, encode_dtype, decode_dtype):
        self.enc = np.dtype(encode_dtype)
        self.dec = np.dtype(decode_dtype)

    def encode(self, arr: np.ndarray) -> np.ndarray:
        return arr.astype(self.enc, copy=False)

    def decode(self, arr: np.ndarray) -> np.ndarray:
        return arr.astype(self.dec, copy=False)

    @property
    def encoded_dtype(self):
        return self.enc


class FixedScaleOffsetFilter:
    def __init__(self, scale, offset, dtype, astype=None):
        self.scale = scale
        self.offset = offset
        self.dtype = np.dtype(dtype)
        self.astype = np.dtype(astype) if astype else self.dtype

    def encode(self, arr: np.ndarray) -> np.ndarray:
        enc = (arr.astype(self.dtype, copy=False) - self.offset) * self.scale
        if self.astype.kind in "ui":
            enc = np.around(enc)
        return enc.astype(self.astype)

    def decode(self, arr: np.ndarray) -> np.ndarray:
        return (arr / self.scale + self.offset).astype(self.dtype)

    @property
    def encoded_dtype(self):
        return self.astype


def filter_from_config(cfg: dict, dtype_in: np.dtype):
    fid = cfg.get("id")
    if fid == "delta":
        return DeltaFilter(cfg.get("dtype", dtype_in), cfg.get("astype"))
    if fid == "shuffle":
        return ShuffleFilter(cfg.get("elementsize", dtype_in.itemsize))
    if fid == "astype":
        return AsTypeFilter(
            cfg.get("encode_dtype", dtype_in), cfg.get("decode_dtype", dtype_in)
        )
    if fid == "fixedscaleoffset":
        return FixedScaleOffsetFilter(
            cfg.get("scale", 1), cfg.get("offset", 0),
            cfg.get("dtype", dtype_in), cfg.get("astype"),
        )
    raise NotImplementedError(
        f"zarr filter {fid!r} not supported (delta, shuffle, astype, "
        f"fixedscaleoffset are)"
    )


# ---------------------------------------------------------------------------
# Attributes (.zattrs)
# ---------------------------------------------------------------------------


class Attributes(dict):
    """Dict persisted to ``.zattrs`` on mutation (small metadata only)."""

    def __init__(self, path: str):
        self._path = os.path.join(path, ".zattrs")
        if os.path.exists(self._path):
            with open(self._path) as f:
                super().__init__(json.load(f))
        else:
            super().__init__()

    def _flush(self):
        with open(self._path, "w") as f:
            json.dump(dict(self), f, indent=2)

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._flush()

    def update(self, *a, **k):
        super().update(*a, **k)
        self._flush()

    def __delitem__(self, k):
        super().__delitem__(k)
        self._flush()


# ---------------------------------------------------------------------------
# Array
# ---------------------------------------------------------------------------


def _normalize_selection(key, shape) -> Tuple[Tuple[int, int], ...]:
    """Normalize an index (ints / step-1 slices / Ellipsis) into per-dim
    (start, stop) plus the positions of integer axes (dropped in the result).
    """
    if not isinstance(key, tuple):
        key = (key,)
    if Ellipsis in key:
        i = key.index(Ellipsis)
        fill = len(shape) - (len(key) - 1)
        key = key[:i] + (slice(None),) * fill + key[i + 1 :]
    key = key + (slice(None),) * (len(shape) - len(key))
    if len(key) != len(shape):
        raise IndexError(f"too many indices for {len(shape)}-d array")
    bounds, int_axes = [], []
    for d, (k, n) in enumerate(zip(key, shape)):
        if isinstance(k, (int, np.integer)):
            k = int(k)
            if k < 0:
                k += n
            if not 0 <= k < n:
                raise IndexError(f"index {k} out of bounds for axis {d} ({n})")
            bounds.append((k, k + 1))
            int_axes.append(d)
        elif isinstance(k, slice):
            if k.step not in (None, 1):
                raise NotImplementedError("strided slicing not supported")
            start, stop, _ = k.indices(n)
            bounds.append((start, max(start, stop)))
        else:
            raise TypeError(f"unsupported index: {k!r}")
    return tuple(bounds), tuple(int_axes)


class ZarrArray:
    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError("only zarr v2 arrays supported")
        if meta.get("order", "C") != "C":
            raise NotImplementedError("only C-order arrays supported")
        self.meta = meta
        # corrupt metadata contract: a malformed .zarray raises ValueError
        # with the offending field, never KeyError/TypeError (fuzz-derived)
        try:
            shape, chunks = meta["shape"], meta["chunks"]
            # must be JSON arrays of integers — a digit STRING would be
            # coerced element-wise by int() ("88" -> (8, 8)) and floats
            # silently truncated, fabricating geometry instead of raising
            if not isinstance(shape, (list, tuple)) or not isinstance(
                chunks, (list, tuple)
            ):
                raise TypeError("shape/chunks must be arrays")
            if not all(isinstance(v, int) for v in (*shape, *chunks)):
                raise TypeError("shape/chunks entries must be integers")
            self.shape = tuple(shape)
            self.chunks = tuple(chunks)
            self.dtype = np.dtype(meta["dtype"])
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed .zarray metadata: {e!r}") from None
        if any(s < 0 for s in self.shape) or any(c <= 0 for c in self.chunks):
            raise ValueError(
                f"malformed .zarray geometry: shape={self.shape} "
                f"chunks={self.chunks}"
            )
        # filter chain: original dtype -> f0 -> f1 -> ... -> compressor
        self.filters = []
        dt = self.dtype
        for cfg in meta.get("filters") or []:
            f = filter_from_config(cfg, dt)
            self.filters.append(f)
            dt = f.encoded_dtype
        self._stored_dtype = dt
        fill = meta.get("fill_value", 0)
        self.fill_value = 0 if fill is None else fill
        self.separator = meta.get("dimension_separator", ".")
        self.codec = codec_from_config(meta.get("compressor"))
        self.attrs = Attributes(path)
        # Serializes CONCURRENT __setitem__ calls on this instance: writes
        # to a chunk only partially covered by the selection read-modify-
        # write the chunk file, and two overlapping writers (e.g. pipeline
        # slab writes when the slab doesn't align to the z-chunk) would
        # lose one writer's planes. Internal per-call parallelism (the
        # module thread pool fan-out) is untouched.
        self._write_lock = threading.Lock()

    # -- creation ----------------------------------------------------------

    @staticmethod
    def create(
        path: str,
        shape: Sequence[int],
        chunks: Sequence[int],
        dtype,
        compressor: Optional[object] = "default",
        fill_value=0,
        dimension_separator: str = "/",
        overwrite: bool = False,
    ) -> "ZarrArray":
        if os.path.exists(path):
            if not overwrite and os.path.exists(os.path.join(path, ".zarray")):
                raise FileExistsError(path)
            if overwrite:
                shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path, exist_ok=True)
        if compressor == "default":
            compressor = BloscCodec()
        dtype = np.dtype(dtype)
        meta = {
            "zarr_format": 2,
            "shape": list(map(int, shape)),
            "chunks": list(map(int, chunks)),
            "dtype": dtype.str,
            "compressor": compressor.config if compressor is not None else None,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
            "dimension_separator": dimension_separator,
        }
        with open(os.path.join(path, ".zarray"), "w") as f:
            json.dump(meta, f, indent=2)
        return ZarrArray(path)

    @staticmethod
    def open(path: str) -> "ZarrArray":
        return ZarrArray(path)

    # -- basic props -------------------------------------------------------

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def itemsize(self):
        return self.dtype.itemsize

    @property
    def nbytes(self):
        return int(np.prod(self.shape)) * self.itemsize

    def __repr__(self):
        return f"<ZarrArray {self.shape} {self.dtype} chunks={self.chunks} at {self.path}>"

    # -- chunk IO ----------------------------------------------------------

    def _chunk_path(self, cidx: Tuple[int, ...]) -> str:
        key = self.separator.join(str(i) for i in cidx)
        return os.path.join(self.path, key)

    def _ensure_dir(self, d: str):
        # memoized makedirs: nested "/"-separated chunk keys hit the same
        # parent dirs hundreds of times per slab write (a set.add race is
        # benign — makedirs is exist_ok)
        made = self.__dict__.setdefault("_made_dirs", set())
        if d not in made:
            os.makedirs(d, exist_ok=True)
            made.add(d)

    def read_chunk(self, cidx: Tuple[int, ...]) -> np.ndarray:
        """Decode one chunk (full chunk shape; missing -> fill_value)."""
        p = self._chunk_path(cidx)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, dtype=self.dtype)
        with open(p, "rb") as f:
            raw = f.read()
        buf = self.codec.decode(raw)
        if self.filters:
            # walk the chain backwards, reinterpreting bytes at each hop
            # (byte-level filters like shuffle emit uint8 buffers)
            dts = [self.dtype] + [f.encoded_dtype for f in self.filters]
            arr = np.frombuffer(buf, dtype=dts[-1])
            for f, dt_in in zip(reversed(self.filters), reversed(dts[:-1])):
                arr = np.asarray(f.decode(arr))
                if arr.dtype != dt_in:
                    if arr.dtype == np.uint8 and dt_in.itemsize > 1:
                        # byte-level filter output: reinterpret, don't cast
                        arr = np.frombuffer(
                            np.ascontiguousarray(arr).tobytes(), dtype=dt_in
                        )
                    else:
                        arr = arr.astype(dt_in)
            return arr.astype(self.dtype, copy=False).reshape(self.chunks).copy()
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.chunks).copy()

    def _read_raw(self, cidx: Tuple[int, ...]) -> Optional[bytes]:
        """Raw frame bytes of one chunk, or None when missing."""
        p = self._chunk_path(cidx)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def _write_frame(self, cidx: Tuple[int, ...], frame):
        """Atomically write one encoded frame (tmp + rename). The single
        write site for every path — per-chunk, batch, and slab."""
        p = self._chunk_path(cidx)
        self._ensure_dir(os.path.dirname(p))
        tmp = p + ".partial"
        try:
            with open(tmp, "wb") as f:
                f.write(frame)
        except FileNotFoundError:
            # the memoized dir was removed externally (cleanup / retry logic
            # recreating the store): drop the memo and recreate once
            self.__dict__.pop("_made_dirs", None)
            self._ensure_dir(os.path.dirname(p))
            with open(tmp, "wb") as f:
                f.write(frame)
        os.replace(tmp, p)

    def write_chunk(self, cidx: Tuple[int, ...], data: np.ndarray):
        """Encode one full-shape chunk."""
        assert data.shape == self.chunks, (data.shape, self.chunks)
        buf = np.ascontiguousarray(data, dtype=self.dtype)
        if self.filters:
            arr = buf
            for f in self.filters:
                arr = f.encode(arr)
            buf = np.ascontiguousarray(arr)
        frame = self.codec.encode(buf.tobytes(), self._stored_dtype.itemsize if self.filters else self.itemsize)
        self._write_frame(cidx, frame)

    def _chunk_range(self, bounds):
        return [
            range(lo // c, -(-hi // c)) if hi > lo else range(0)
            for (lo, hi), c in zip(bounds, self.chunks)
        ]

    # -- slicing -----------------------------------------------------------

    def _scatter_sel(self, cid, bounds):
        src_sel, dst_sel = [], []
        for d, ((lo, hi), c) in enumerate(zip(bounds, self.chunks)):
            c0 = cid[d] * c
            s_lo = max(lo, c0)
            s_hi = min(hi, c0 + c)
            src_sel.append(slice(s_lo - c0, s_hi - c0))
            dst_sel.append(slice(s_lo - lo, s_hi - lo))
        return tuple(src_sel), tuple(dst_sel)

    def _grid_view(self, bounds, arr):
        """(arr3, chunks3) for the native slab codecs — a (z, y, x) view of
        ``arr`` whose selection is exactly a chunk-grid-aligned block — or
        None when the selection/layout is ineligible. Leading dims (beyond
        the last three) must be unit-extent with unit chunks, so the task
        list's C order equals the 3-D grid order."""
        nd = len(self.shape)
        for d, ((lo, hi), c, n) in enumerate(zip(bounds, self.chunks, self.shape)):
            if d < nd - 3:
                if c != 1 or hi - lo != 1:
                    return None
            elif lo % c != 0 or (hi != n and hi % c != 0) or hi <= lo:
                return None
        if arr.ndim < 3:
            arr = arr[(None,) * (3 - arr.ndim)]
        else:
            arr = arr.reshape(arr.shape[-3:]) if arr.ndim > 3 else arr
        if arr.strides[-1] != arr.itemsize:
            return None
        return arr, tuple(self.chunks[-3:]) if nd >= 3 else (
            (1,) * (3 - nd) + tuple(self.chunks)
        )

    def __getitem__(self, key) -> np.ndarray:
        bounds, int_axes = _normalize_selection(key, self.shape)
        out_shape = tuple(hi - lo for lo, hi in bounds)
        out = np.empty(out_shape, dtype=self.dtype)
        if 0 in out_shape:
            return out.squeeze(axis=int_axes) if int_axes else out

        ranges = self._chunk_range(bounds)
        tasks = [
            tuple(r[i] for r, i in zip(ranges, cidx))
            for cidx in np.ndindex(*[len(r) for r in ranges])
        ]

        if (
            len(tasks) >= 8
            and not self.filters
            and hasattr(self.codec, "decode_slab")
        ):
            # slab fast path: threaded raw reads, then ONE native call that
            # decodes AND scatters into `out` (no intermediate chunk arrays)
            gv = self._grid_view(bounds, out)
            if gv is not None:
                raws = list(_pool.map(self._read_raw, tasks))
                if self.codec.decode_slab(raws, gv[0], gv[1], self.fill_value):
                    return out.squeeze(axis=int_axes) if int_axes else out

        if (
            len(tasks) >= 8
            and not self.filters
            and hasattr(self.codec, "decode_batch")
        ):
            # bulk path: threaded raw file reads, ONE native batch decode,
            # then scatter — avoids per-chunk Python codec dispatch
            raws = list(_pool.map(self._read_raw, tasks))
            present = [i for i, r in enumerate(raws) if r is not None]
            bufs = self.codec.decode_batch([raws[i] for i in present])
            chunks = {}
            for j, i in enumerate(present):
                chunks[i] = np.frombuffer(bufs[j], dtype=self.dtype).reshape(
                    self.chunks
                )
            fill = None
            for i, cid in enumerate(tasks):
                chunk = chunks.get(i)
                if chunk is None:
                    if fill is None:
                        fill = np.full(self.chunks, self.fill_value, self.dtype)
                    chunk = fill
                src_sel, dst_sel = self._scatter_sel(cid, bounds)
                out[dst_sel] = chunk[src_sel]
            return out.squeeze(axis=int_axes) if int_axes else out

        def fetch(cid):
            chunk = self.read_chunk(cid)
            src_sel, dst_sel = self._scatter_sel(cid, bounds)
            out[dst_sel] = chunk[src_sel]

        list(_pool.map(fetch, tasks))
        return out.squeeze(axis=int_axes) if int_axes else out

    def __setitem__(self, key, value):
        with self._write_lock:
            self._setitem_locked(key, value)

    def _setitem_locked(self, key, value):
        bounds, int_axes = _normalize_selection(key, self.shape)
        sel_shape = tuple(hi - lo for lo, hi in bounds)
        value = np.asarray(value)
        # numpy-style cast (float -> uint16 truncates/wraps, like zarr)
        value = np.broadcast_to(value.astype(self.dtype, copy=False), sel_shape)

        ranges = self._chunk_range(bounds)
        tasks = [
            tuple(r[i] for r, i in zip(ranges, cidx))
            for cidx in np.ndindex(*[len(r) for r in ranges])
        ]

        def assemble(cid):
            src_sel, dst_sel, full, whole = [], [], True, True
            for d, ((lo, hi), c, n) in enumerate(
                zip(bounds, self.chunks, self.shape)
            ):
                c0 = cid[d] * c
                s_lo = max(lo, c0)
                s_hi = min(hi, c0 + c)
                src_sel.append(slice(s_lo - lo, s_hi - lo))
                dst_sel.append(slice(s_lo - c0, s_hi - c0))
                covered = s_hi - s_lo
                if covered < min(c, n - c0):
                    full = False
                if covered < c:
                    whole = False
            if whole:
                # every buffer cell is about to be overwritten: skip the
                # fill memset (2 MB/chunk at production geometry)
                chunk = np.empty(self.chunks, dtype=self.dtype)
            elif full:
                # covers the chunk's in-array extent, but the chunk sticks
                # out past the array edge: pad cells must hold fill_value
                chunk = np.full(self.chunks, self.fill_value, dtype=self.dtype)
            else:
                chunk = self.read_chunk(cid)
            chunk[tuple(dst_sel)] = value[tuple(src_sel)]
            return chunk

        if (
            len(tasks) >= 8
            and not self.filters
            and hasattr(self.codec, "encode_slab")
        ):
            # slab fast path: ONE native call gathers each grid chunk from
            # the strided source and encodes it in-cache (no 2 MB/chunk
            # assemble copies), then threaded file writes
            gv = self._grid_view(bounds, value)
            if gv is not None:
                frames = self.codec.encode_slab(gv[0], gv[1], self.fill_value)
                if frames is not None:
                    list(_pool.map(
                        lambda a: self._write_frame(*a), zip(tasks, frames)
                    ))
                    return

        if (
            len(tasks) >= 8
            and not self.filters
            and hasattr(self.codec, "encode_batch")
        ):
            # bulk path: threaded assembly, ONE native batch encode, then
            # threaded file writes
            chunks = list(_pool.map(assemble, tasks))
            frames = self.codec.encode_batch(
                [np.ascontiguousarray(c, dtype=self.dtype) for c in chunks],
                self.itemsize,
            )

            list(_pool.map(
                lambda a: self._write_frame(*a), zip(tasks, frames)
            ))
            return

        def put(cid):
            self.write_chunk(cid, assemble(cid))

        list(_pool.map(put, tasks))


# ---------------------------------------------------------------------------
# Group
# ---------------------------------------------------------------------------


class ZarrGroup:
    def __init__(self, path: str, create: bool = False):
        self.path = path
        zgroup = os.path.join(path, ".zgroup")
        if create:
            os.makedirs(path, exist_ok=True)
            if not os.path.exists(zgroup):
                with open(zgroup, "w") as f:
                    json.dump({"zarr_format": 2}, f)
        elif not os.path.exists(zgroup):
            raise FileNotFoundError(zgroup)
        self.attrs = Attributes(path)

    def create_group(self, name: str, overwrite: bool = False) -> "ZarrGroup":
        p = os.path.join(self.path, str(name))
        if overwrite and os.path.exists(p):
            shutil.rmtree(p)
        return ZarrGroup(p, create=True)

    def create_dataset(
        self,
        name,
        shape,
        chunks,
        dtype,
        compressor="default",
        dimension_separator: str = "/",
        overwrite: bool = False,
        fill_value=0,
    ) -> ZarrArray:
        return ZarrArray.create(
            os.path.join(self.path, str(name)),
            shape=shape,
            chunks=chunks,
            dtype=dtype,
            compressor=compressor,
            fill_value=fill_value,
            dimension_separator=dimension_separator,
            overwrite=overwrite,
        )

    def __getitem__(self, name):
        p = os.path.join(self.path, str(name))
        if os.path.exists(os.path.join(p, ".zarray")):
            return ZarrArray(p)
        if os.path.exists(os.path.join(p, ".zgroup")):
            return ZarrGroup(p)
        raise KeyError(name)

    def __contains__(self, name):
        p = os.path.join(self.path, str(name))
        return os.path.exists(os.path.join(p, ".zarray")) or os.path.exists(
            os.path.join(p, ".zgroup")
        )

    def keys(self):
        if not os.path.isdir(self.path):
            return
        for entry in sorted(os.listdir(self.path)):
            p = os.path.join(self.path, entry)
            if os.path.exists(os.path.join(p, ".zarray")) or os.path.exists(
                os.path.join(p, ".zgroup")
            ):
                yield entry


def group(path: str) -> ZarrGroup:
    """Create-or-open a group (zarr.group analog)."""
    return ZarrGroup(path, create=True)


def open_zarr(path: str):
    """Open an array or group at ``path``."""
    if os.path.exists(os.path.join(path, ".zarray")):
        return ZarrArray(path)
    if os.path.exists(os.path.join(path, ".zgroup")):
        return ZarrGroup(path)
    raise FileNotFoundError(f"no zarr array/group at {path}")
