"""
Blosc1 chunk codec (zstd + byte/bit-shuffle), the format used by the reference
output store (zarr_destriper.py:1071: ``Blosc(cname="zstd", clevel=3,
shuffle=SHUFFLE)``) and by SmartSPIM input tiles.

The port's own copy of ``aind_smartspim_destripe_tpu/io/blosc.py``. Two
backends, in preference order:
1. the native C++ runtime (this package's ``csrc/destripe_runtime.cpp``,
   multithreaded, loaded via ctypes), built at first use by :mod:`.codec`,
2. a pure-Python/numpy + `zstandard` implementation of the same frame format.

Frame format implemented (c-blosc 1.x; encode is zstd-only like the
reference store, decode covers EVERY stock c-blosc codec —
zstd/zlib/lz4/lz4hc/blosclz/snappy; lz4 is zarr-python's DEFAULT
compressor and blosclz is c-blosc's own default, so input tiles written by
generic zarr tooling decode here without numcodecs):

  header[16]: version(1B)=2, versionlz(1B)=1, flags(1B), typesize(1B),
              nbytes(u32le), blocksize(u32le), cbytes(u32le)
  flags: 0x01 byte-shuffle | 0x02 memcpyed | 0x04 bit-shuffle,
         0x10 blocks are NOT split (c-blosc >= 1.14 writes it for zstd),
         compressor code in bits 5-7 (zstd=4, zlib=3, lz4=1, blosclz=0)
  then (unless memcpyed): int32le block offsets (from frame start), then per
  block: [int32le csize][codec stream]; csize == uncompressed block length
  means the block is stored raw. Shuffle is applied per block. When flag
  0x10 is CLEAR (lz4/blosclz writers), each full block is "split" into
  `typesize` independent [csize][stream] sub-streams (conditions mirrored
  from c-blosc's blosc_d: typesize <= 16, blocksize/typesize >= 128, not
  the ragged final block).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import struct
from typing import Optional

import numpy as np

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

NOSHUFFLE = 0
SHUFFLE = 1  # byte shuffle
BITSHUFFLE = 2

_COMPRESSOR_CODES = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2, "zlib": 3, "zstd": 4}
_DEFAULT_BLOCKSIZE = 1 << 18  # 256 KiB


# ---------------------------------------------------------------------------
# Shuffle filters (numpy-vectorized)
# ---------------------------------------------------------------------------


def byte_shuffle(data: bytes | np.ndarray, typesize: int) -> bytes:
    """Transpose the byte planes of `data` (length need not divide typesize:
    the trailing remainder bytes are copied through, like c-blosc)."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = buf.size
    if typesize <= 1 or n < typesize:
        return buf.tobytes()
    nelem = n // typesize
    main = buf[: nelem * typesize].reshape(nelem, typesize).T
    out = np.empty(n, dtype=np.uint8)
    out[: nelem * typesize] = main.reshape(-1)
    out[nelem * typesize :] = buf[nelem * typesize :]
    return out.tobytes()


def byte_unshuffle(data: bytes, typesize: int) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if typesize <= 1 or n < typesize:
        return bytes(data)
    nelem = n // typesize
    main = buf[: nelem * typesize].reshape(typesize, nelem).T
    out = np.empty(n, dtype=np.uint8)
    out[: nelem * typesize] = main.reshape(-1)
    out[nelem * typesize :] = buf[nelem * typesize :]
    return out.tobytes()


def _bitshuffle_extent(n: int, typesize: int) -> int:
    """Bytes of a block c-blosc's bitshuffle actually bit-transposes.

    c-blosc 1.x shuffle.c: the transpose runs iff the block's whole-element
    count (``n // typesize``) is a multiple of 8 (any typesize — 1.21's
    bshuf handles non-power-of-two sizes too); then the sub-element tail
    (``n % typesize`` bytes, only possible on the ragged final block) is
    memcpy'd behind it. Any other block passes through raw. Round 1's
    "all-or-nothing on n % (ts*8)" matched every aligned case but
    mis-handled ragged FINAL blocks whose element count is still a multiple
    of 8 (e.g. ts=8, 82503-byte leftover = 10312 elements + 7 tail bytes —
    c-blosc transposes 82496 and copies 7); verified against libblosc 1.21
    frames both ways."""
    if typesize < 1:
        return 0
    nelem = n // typesize
    if nelem == 0 or nelem % 8 != 0:
        return 0
    return nelem * typesize


def bit_shuffle(data: bytes, typesize: int) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8)
    aligned = _bitshuffle_extent(buf.size, typesize)
    if aligned == 0:
        return bytes(data)
    nelem = aligned // typesize
    bits = np.unpackbits(
        buf[:aligned].reshape(nelem, typesize), axis=None, bitorder="little"
    )
    bits = bits.reshape(nelem, typesize * 8).T
    return (
        np.packbits(bits, bitorder="little").tobytes()
        + buf[aligned:].tobytes()
    )


def bit_unshuffle(data: bytes, typesize: int) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8)
    aligned = _bitshuffle_extent(buf.size, typesize)
    if aligned == 0:
        return bytes(data)
    nelem = aligned // typesize
    bits = np.unpackbits(buf[:aligned], bitorder="little").reshape(
        typesize * 8, nelem
    ).T
    return (
        np.packbits(bits.reshape(-1), bitorder="little").tobytes()
        + buf[aligned:].tobytes()
    )


# ---------------------------------------------------------------------------
# Pure-python frame codec
# ---------------------------------------------------------------------------


def _pick_blocksize(nbytes: int, typesize: int, requested: int = 0, shuffle: int = SHUFFLE) -> int:
    bs = requested or _DEFAULT_BLOCKSIZE
    bs = max(typesize, min(bs, nbytes)) if nbytes else typesize
    # Keep blocks element-aligned; for bitshuffle align to whole 8-element
    # groups, since c-blosc skips the transpose on unaligned blocks.
    align = typesize * 8 if shuffle == BITSHUFFLE else typesize
    if align > 1:
        bs -= bs % align
    bs = max(bs, align)
    # c-blosc rejects frames whose header blocksize exceeds nbytes; a short
    # unaligned block simply skips the shuffle (see bit_shuffle).
    if nbytes and bs > nbytes:
        bs = nbytes
    return bs


def compress_py(
    data: bytes | memoryview | np.ndarray,
    typesize: int,
    clevel: int = 3,
    shuffle: int = SHUFFLE,
    cname: str = "zstd",
    blocksize: int = 0,
) -> bytes:
    if cname != "zstd":
        raise NotImplementedError(
            f"encode supports zstd only (the output-store codec, reference "
            f"zarr_destriper.py:1071); {cname!r} frames are decode-only here "
            f"— re-create the store with zstd to write"
        )
    if _zstd is None:  # pragma: no cover
        raise RuntimeError("zstandard module unavailable")
    if isinstance(data, np.ndarray):
        # ascontiguousarray: frombuffer rejects non-C-contiguous exports
        raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    else:
        raw = np.frombuffer(data, np.uint8)
    nbytes = raw.size
    bs = _pick_blocksize(nbytes, typesize, blocksize, shuffle)
    nblocks = max(1, -(-nbytes // bs))

    # zstd level mapping: c-blosc maps clevel 1..9 onto the codec's range;
    # exact level only affects ratio, not format compatibility.
    cctx = _zstd.ZstdCompressor(level=clevel)

    # 0x10 advertises the non-split block layout (c-blosc >= 1.14 sets it for
    # codecs like zstd whose blocks are single streams; decoders require it).
    flags = 0x10
    if shuffle == SHUFFLE and typesize > 1:
        flags |= 0x01
    elif shuffle == BITSHUFFLE:
        flags |= 0x04
    flags |= _COMPRESSOR_CODES[cname] << 5

    blocks = []
    for b in range(nblocks):
        seg = raw[b * bs : min((b + 1) * bs, nbytes)].tobytes()
        if flags & 0x01:
            seg = byte_shuffle(seg, typesize)
        elif flags & 0x04:
            seg = bit_shuffle(seg, typesize)
        comp = cctx.compress(seg)
        if len(comp) >= len(seg):
            blocks.append(struct.pack("<i", len(seg)) + seg)  # stored raw
        else:
            blocks.append(struct.pack("<i", len(comp)) + comp)

    bstart_sz = 4 * nblocks
    total = 16 + bstart_sz + sum(len(b) for b in blocks)
    if total >= nbytes + 16:
        # incompressible: memcpy frame
        header = struct.pack(
            "<BBBBIII", 2, 1, (flags & 0xF0) | 0x02, typesize, nbytes, bs, nbytes + 16
        )
        return header + raw.tobytes()

    header = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, bs, total)
    offsets = []
    pos = 16 + bstart_sz
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    return header + struct.pack(f"<{nblocks}i", *offsets) + b"".join(blocks)


def _emit_match(out: bytearray, dist: int, mlen: int, what: str) -> None:
    """Append a back-reference copy of ``mlen`` bytes at distance ``dist``
    (shared by the lz4/snappy/blosclz decoders — the subtle overlapping
    self-reference case lives in exactly one place)."""
    if dist == 0 or dist > len(out):
        raise ValueError(f"{what} match offset out of range")
    start = len(out) - dist
    if dist >= mlen:
        out += out[start : start + mlen]
    else:  # overlapping match: byte-serial self-reference
        for k in range(mlen):
            out.append(out[start + k])


def _lz4_block_decompress(src: bytes, dlen: int) -> bytes:
    """Decode one raw LZ4 block (the stable public block format shared by
    lz4 and lz4hc — compression level changes only the encoder's search).
    Pure-python fallback; the native runtime carries the fast path."""
    try:
        return _lz4_block_decompress_inner(src, dlen)
    except IndexError:
        raise ValueError("truncated lz4 block") from None


def _lz4_block_decompress_inner(src: bytes, dlen: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        if len(out) > dlen:  # cannot be valid; stop before 255x expansion
            raise ValueError("lz4 block overruns its declared length")
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4 literal run past end of block")
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # final literals-only sequence
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = token & 0x0F
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        _emit_match(out, off, mlen + 4, "lz4")
    if len(out) != dlen:
        raise ValueError(f"lz4 block decoded {len(out)} bytes, expected {dlen}")
    return bytes(out)


def _snappy_block_decompress(src: bytes, dlen: int) -> bytes:
    """Decode one raw snappy block (the public format: varint uncompressed
    length, then literal/copy elements). Dependency-free fallback for
    foreign blosc-snappy frames."""
    try:
        return _snappy_block_decompress_inner(src, dlen)
    except IndexError:
        raise ValueError("truncated snappy block") from None


def _snappy_block_decompress_inner(src: bytes, dlen: int) -> bytes:
    i, n = 0, len(src)
    # varint32 uncompressed length
    ulen = shift = 0
    while True:
        b = src[i]
        i += 1
        ulen |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
        if shift > 32:
            raise ValueError("snappy varint overflow")
    if ulen != dlen:
        raise ValueError(f"snappy block advertises {ulen} bytes, expected {dlen}")
    out = bytearray()
    while i < n:
        if len(out) > dlen:  # cannot be valid; stop before 64 KiB+ tags
            raise ValueError("snappy block overruns its declared length")
        tag = src[i]
        i += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(src[i : i + nb], "little")
                i += nb
            ln += 1
            if i + ln > n:
                raise ValueError("snappy literal past end of block")
            out += src[i : i + ln]
            i += ln
            continue
        if kind == 1:  # copy with 1-byte offset
            ln = ((tag >> 2) & 0x07) + 4
            off = ((tag >> 5) << 8) | src[i]
            i += 1
        elif kind == 2:  # copy with 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[i : i + 2], "little")
            i += 2
        else:  # copy with 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[i : i + 4], "little")
            i += 4
        _emit_match(out, off, ln, "snappy")
    if len(out) != dlen:
        raise ValueError(f"snappy block decoded {len(out)} bytes, expected {dlen}")
    return bytes(out)


def _blosclz_block_decompress(src: bytes, dlen: int) -> bytes:
    """Decode one blosclz block (c-blosc's own default codec, FastLZ-derived
    format version 1). Near matches: distance = ((ctrl & 31) << 8) + code + 1;
    far matches (code == 255 with the 13-bit offset saturated): two extra
    bytes, distance = ofs16 + 8192. Both branches pinned empirically against
    libblosc 1.21 streams (hand-decoded and fuzzed)."""
    try:
        return _blosclz_block_decompress_inner(src, dlen)
    except IndexError:
        raise ValueError("truncated blosclz block") from None


def _blosclz_block_decompress_inner(src: bytes, dlen: int) -> bytes:
    out = bytearray()
    n = len(src)
    if n == 0:
        raise ValueError("empty blosclz block")
    ctrl = src[0] & 31
    i = 1
    while True:
        if len(out) > dlen:  # cannot be valid; stop before 255x expansion
            raise ValueError("blosclz block overruns its declared length")
        if ctrl < 32:
            if i + ctrl + 1 > n:
                raise ValueError("blosclz literal run past end of block")
            out += src[i : i + ctrl + 1]
            i += ctrl + 1
        else:
            mlen = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if mlen == 6:
                while True:
                    c = src[i]
                    i += 1
                    mlen += c
                    if c != 255:
                        break
            code = src[i]
            i += 1
            if code == 255 and ofs == (31 << 8):
                dist = ((src[i] << 8) | src[i + 1]) + 8192
                i += 2
            else:
                dist = ofs + code + 1
            _emit_match(out, dist, mlen + 3, "blosclz")
        if i >= n:
            break
        ctrl = src[i]
        i += 1
    if len(out) != dlen:
        raise ValueError(
            f"blosclz block decoded {len(out)} bytes, expected {dlen}"
        )
    return bytes(out)


def decompress_py(frame: bytes | memoryview) -> bytes:
    frame = bytes(frame)
    if len(frame) < 16:
        raise ValueError("truncated blosc frame")
    version, versionlz, flags, typesize, nbytes, blocksize, cbytes = struct.unpack(
        "<BBBBIII", frame[:16]
    )
    if flags & 0x02:  # memcpyed
        if len(frame) < 16 + nbytes:
            raise ValueError("truncated blosc frame")
        return frame[16 : 16 + nbytes]
    if nbytes == 0:
        return b""
    code = (flags >> 5) & 0x07
    if code == 4:
        if _zstd is None:  # pragma: no cover
            raise RuntimeError("zstandard module unavailable")
        dctx = _zstd.ZstdDecompressor()

        def decomp(b, hint):
            # decoder contract: every malformed frame raises ValueError —
            # zstandard's ZstdError must not escape (fuzz-derived)
            try:
                return dctx.decompress(b, max_output_size=hint)
            except _zstd.ZstdError as e:
                raise ValueError(f"corrupt zstd block: {e}") from None
    elif code == 3:
        import zlib

        def decomp(b, hint):
            # Bound the inflate at the declared (sub-)stream length like the
            # lz4/snappy/blosclz decoders: a crafted zlib stream must not be
            # able to expand past `hint` before the final length check.
            # hint=0 would mean UNLIMITED to zlib — nothing legitimate
            # decodes a 0-byte sub-stream from a nonzero payload.
            if hint <= 0:
                raise ValueError("zlib block with zero declared length")
            obj = zlib.decompressobj()
            try:
                out = obj.decompress(bytes(b), hint)
            except zlib.error as e:  # decoder contract: ValueError only
                raise ValueError(f"corrupt zlib block: {e}") from None
            if obj.unconsumed_tail or not obj.eof or obj.unused_data:
                raise ValueError(
                    f"zlib block decoded past declared length {hint}"
                )
            return out
    elif code == 1:
        decomp = _lz4_block_decompress
    elif code == 0:
        decomp = _blosclz_block_decompress
    elif code == 2:
        decomp = _snappy_block_decompress
    else:
        raise NotImplementedError(f"blosc inner codec {code} not supported")

    # c-blosc splits each full block of an lz4/blosclz frame into `typesize`
    # independently-coded sub-streams; >=1.14 advertises non-split with flag
    # 0x10 (blosc_d's exact conditions mirrored below)
    may_split = (
        not (flags & 0x10)
        and 1 < typesize <= 16
        and blocksize % typesize == 0
        and blocksize // typesize >= 128
    )
    nblocks = max(1, -(-nbytes // blocksize)) if blocksize else 1
    if len(frame) < 16 + 4 * nblocks:
        # a corrupt header can declare a tiny blocksize for a large nbytes;
        # the offsets table then claims more than the whole frame
        raise ValueError("truncated blosc frame (block offsets table)")
    offsets = struct.unpack(f"<{nblocks}i", frame[16 : 16 + 4 * nblocks])
    out = bytearray()
    for b, off in enumerate(offsets):
        neblock = min(blocksize, nbytes - b * blocksize)
        nsplits = typesize if (may_split and neblock == blocksize) else 1
        ssize = neblock // nsplits
        parts = []
        if off < 0:
            # offsets are signed on the wire; a negative one would wrap
            # through Python's negative slicing below and bypass the
            # bounds guards (fuzz-derived)
            raise ValueError("negative blosc block offset")
        p = off
        for _j in range(nsplits):
            if p + 4 > len(frame):
                raise ValueError("truncated blosc frame")
            (csize,) = struct.unpack("<i", frame[p : p + 4])
            if csize < 0 or p + 4 + csize > len(frame):
                raise ValueError("truncated blosc frame")
            payload = frame[p + 4 : p + 4 + csize]
            p += 4 + csize
            parts.append(
                bytes(payload) if csize == ssize else decomp(payload, ssize)
            )
        seg = b"".join(parts)
        if flags & 0x01:
            seg = byte_unshuffle(seg, typesize)
        elif flags & 0x04:
            seg = bit_unshuffle(seg, typesize)
        out += seg
    if len(out) != nbytes:
        raise ValueError(f"blosc frame decoded {len(out)} bytes, expected {nbytes}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Native C++ runtime backend (preferred)
# ---------------------------------------------------------------------------

_native = None


def _load_native():
    """The native runtime (a bound ``ctypes.CDLL``), built on first use by
    :func:`.codec.load_native_codec`, or False where no C++ compiler is (the
    python codec then serves)."""
    global _native
    if _native is None:
        from .codec import load_native_codec

        _native = load_native_codec()
    return _native


def _n_codec_threads() -> int:
    env = os.environ.get("DESTRIPE_CODEC_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            raise ValueError(
                f"DESTRIPE_CODEC_THREADS must be an integer, got {env!r}"
            ) from None
    return min(32, os.cpu_count() or 4)


def compress_batch(
    chunks: list,
    typesize: int,
    clevel: int = 3,
    shuffle: int = SHUFFLE,
    cname: str = "zstd",
    copy: bool = False,
    threads: Optional[int] = None,
) -> list:
    """Encode many frames in ONE native call (the C++ runtime fans the
    batch over its own threads — no per-chunk Python dispatch). Falls back
    to per-frame compress() when the native library is absent.

    Returns buffer-protocol frames, NOT necessarily ``bytes``: on the
    native path each element is a zero-copy ``memoryview`` into one shared
    destination block, sized for the whole batch. ``file.write(frame)`` and
    ``len(frame)`` work directly; call ``bytes(frame)`` before pickling,
    hashing, or retaining a single frame long-term (any retained view keeps
    the whole batch block alive) — or pass ``copy=True`` to get independent
    ``bytes`` frames (one extra memcpy per frame, off the hot path)."""
    lib = _load_native()
    if not lib or cname != "zstd" or not chunks:
        return [compress(c, typesize, clevel, shuffle, cname) for c in chunks]
    n = len(chunks)
    # zero-copy sources: pass ndarray/bytes buffers by address
    keep, ptrs, src_lens = [], [], []
    for c in chunks:
        if isinstance(c, np.ndarray):
            a = np.ascontiguousarray(c)
            keep.append(a)
            ptrs.append(a.ctypes.data)
            src_lens.append(a.nbytes)
        else:
            b = bytes(c)
            keep.append(b)
            ptrs.append(ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p).value)
            src_lens.append(len(b))
    caps = [ln + 16 + 4096 for ln in src_lens]
    offs = np.concatenate([[0], np.cumsum(caps)])
    dst_np = np.empty(int(offs[-1]), np.uint8)  # uninitialized, one block
    base = dst_np.ctypes.data
    srcs = (ctypes.c_char_p * n)(*ptrs)
    lens = (ctypes.c_size_t * n)(*src_lens)
    dsts = (ctypes.c_char_p * n)(*[base + int(o) for o in offs[:-1]])
    dcaps = (ctypes.c_size_t * n)(*caps)
    outl = (ctypes.c_longlong * n)()
    rc = lib.blosc1_compress_batch(
        n, srcs, lens, typesize, clevel, shuffle, dsts, dcaps, outl,
        threads or _n_codec_threads(),
    )
    if rc != 0:
        return [compress(c, typesize, clevel, shuffle, cname) for c in chunks]
    # memoryviews into the shared destination block (zero-copy, like
    # decompress_batch): file writers take them directly, and each view
    # keeps the backing block alive
    views = [
        dst_np[int(offs[i]) : int(offs[i]) + outl[i]].data for i in range(n)
    ]
    return [bytes(v) for v in views] if copy else views


def _fill_pattern(fill_value, dtype) -> int:
    """Little-endian byte pattern of one ``fill_value`` element as an int
    (what the native slab codecs stamp into pad/missing cells)."""
    b = np.asarray(fill_value if fill_value is not None else 0, dtype).tobytes()
    return int.from_bytes(b, "little")


def compress_slab(
    arr: np.ndarray,  # 3-D slab view, x-contiguous (strides[-1]==itemsize)
    chunks,  # (cz, cy, cx)
    clevel: int = 3,
    shuffle: int = SHUFFLE,
    fill_value=0,
    threads: Optional[int] = None,
):
    """Gather+encode the whole chunk grid of a strided 3-D slab in ONE
    native call (csrc blosc1_compress_slab): no intermediate chunk arrays,
    the slab->chunk copy happens in-cache right before the encode. Returns
    grid-ordered (C order) zero-copy memoryview frames, or ``None`` when the
    native path is unavailable/ineligible (caller falls back)."""
    lib = _load_native()
    if not lib or not hasattr(lib, "blosc1_compress_slab"):
        return None
    arr = np.asarray(arr)
    ts = arr.itemsize
    if arr.ndim != 3 or arr.strides[-1] != ts or ts > 8:
        return None
    cz, cy, cx = (int(c) for c in chunks)
    sz, sy, sx = arr.shape
    nz, ny, nx = -(-sz // cz), -(-sy // cy), -(-sx // cx)
    n = nz * ny * nx
    cap = cz * cy * cx * ts + 16 + 4096
    dst_np = np.empty(n * cap, np.uint8)
    base = dst_np.ctypes.data
    dsts = (ctypes.c_char_p * n)(*[base + i * cap for i in range(n)])
    dcaps = (ctypes.c_size_t * n)(*([cap] * n))
    outl = (ctypes.c_longlong * n)()
    rc = lib.blosc1_compress_slab(
        arr.ctypes.data, sz, sy, sx, arr.strides[0], arr.strides[1],
        cz, cy, cx, ts, clevel, shuffle,
        _fill_pattern(fill_value, arr.dtype),
        dsts, dcaps, outl, threads or _n_codec_threads(),
    )
    if rc != 0:
        return None
    return [dst_np[i * cap : i * cap + outl[i]].data for i in range(n)]


def decompress_slab(
    frames: list,  # grid-ordered frames; None entries = missing chunks
    out: np.ndarray,  # 3-D slab view to scatter into (x-contiguous)
    chunks,
    fill_value=0,
    threads: Optional[int] = None,
) -> bool:
    """Decode+scatter a whole chunk grid into a strided 3-D slab in ONE
    native call (csrc blosc1_decompress_slab). Returns False when the
    native path is unavailable/ineligible or any frame fails (caller falls
    back; ``out`` contents are then undefined)."""
    lib = _load_native()
    if not lib or not hasattr(lib, "blosc1_decompress_slab"):
        return False
    ts = out.itemsize
    if out.ndim != 3 or out.strides[-1] != ts or ts > 8:
        return False
    cz, cy, cx = (int(c) for c in chunks)
    sz, sy, sx = out.shape
    n = (-(-sz // cz)) * (-(-sy // cy)) * (-(-sx // cx))
    if len(frames) != n:
        return False
    chunk_bytes = cz * cy * cx * ts
    keep = []
    srcs = (ctypes.c_char_p * n)()
    lens = (ctypes.c_size_t * n)()
    for i, f in enumerate(frames):
        if f is None:
            srcs[i], lens[i] = None, 0
            continue
        b = f if isinstance(f, bytes) else bytes(f)
        # native decode covers memcpy/zstd/lz4/blosclz/snappy, full-chunk
        # frames only
        if len(b) < 16 or struct.unpack("<I", b[4:8])[0] != chunk_bytes:
            return False
        code = (b[2] >> 5) & 0x07
        if code not in (0, 1, 2, 4) and not (b[2] & 0x02):
            return False
        keep.append(b)
        srcs[i] = b
        lens[i] = len(b)
    rc = lib.blosc1_decompress_slab(
        srcs, lens, out.ctypes.data, sz, sy, sx,
        out.strides[0], out.strides[1], cz, cy, cx, ts,
        _fill_pattern(fill_value, out.dtype), threads or _n_codec_threads(),
    )
    return rc == 0


def decompress_batch(frames: list, threads: Optional[int] = None) -> list:
    """Decode many blosc1 frames in ONE native call; python fallback per
    frame for anything the native path rejects."""
    lib = _load_native()
    frames_b = [f if isinstance(f, bytes) else bytes(f) for f in frames]
    if not lib or not frames_b:
        return [decompress_py(f) for f in frames_b]
    # frames shorter than a blosc header can't even be classified — route
    # them to the python decoder, which raises the contract ValueError
    nbytes = [
        struct.unpack("<I", f[4:8])[0] if len(f) >= 16 else 0
        for f in frames_b
    ]
    native_ok = [
        len(f) >= 16 and (((f[2] >> 5) & 0x07) in (0, 1, 2, 4) or (f[2] & 0x02))
        for f in frames_b
    ]
    n = len(frames_b)
    caps = [max(m, 1) for m in nbytes]
    offs = np.concatenate([[0], np.cumsum(caps)])
    dst_np = np.empty(int(offs[-1]), np.uint8)  # uninitialized, one block
    base = dst_np.ctypes.data
    idx = [i for i in range(n) if native_ok[i]]
    if idx:
        k = len(idx)
        srcs = (ctypes.c_char_p * k)(*[frames_b[i] for i in idx])
        lens = (ctypes.c_size_t * k)(*[len(frames_b[i]) for i in idx])
        dsts = (ctypes.c_char_p * k)(*[base + int(offs[i]) for i in idx])
        dcaps = (ctypes.c_size_t * k)(*[caps[i] for i in idx])
        outl = (ctypes.c_longlong * k)()
        rc = lib.blosc1_decompress_batch(k, srcs, lens, dsts, dcaps, outl,
                                         threads or _n_codec_threads())
        if rc == 0:
            for j, i in enumerate(idx):
                native_ok[i] = outl[j] == nbytes[i]
        else:
            native_ok = [False] * n
    # memoryviews into the shared block: zero-copy for numpy consumers,
    # content-comparable with bytes
    return [
        dst_np[int(offs[i]) : int(offs[i]) + nbytes[i]].data
        if native_ok[i]
        else decompress_py(frames_b[i])
        for i in range(n)
    ]


def compress(
    data,
    typesize: int,
    clevel: int = 3,
    shuffle: int = SHUFFLE,
    cname: str = "zstd",
    blocksize: int = 0,
) -> bytes:
    """Encode one blosc1 frame (native backend when built, python otherwise)."""
    lib = _load_native()
    if lib and cname == "zstd":
        if isinstance(data, np.ndarray):
            src = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        else:
            data = bytes(data)
            src = np.frombuffer(data, np.uint8)
        # np.empty, not create_string_buffer: the latter zero-fills the
        # whole capacity (a full extra memset per MB-scale frame)
        dst = np.empty(src.nbytes + 16 + 4096, np.uint8)
        n = lib.blosc1_compress(
            ctypes.c_char_p(src.ctypes.data), src.nbytes, typesize, clevel,
            shuffle, ctypes.c_char_p(dst.ctypes.data), dst.nbytes,
        )
        if n > 0:
            return dst[:n].tobytes()
        # fall back with the already-normalized contiguous view — the
        # original may be a non-contiguous ndarray compress_py rejects
        data = src
    return compress_py(data, typesize, clevel, shuffle, cname, blocksize)


def decompress(frame) -> bytes:
    """Decode one blosc1 frame (native backend when possible).

    Zero-copy destination decodes are served by :func:`decompress_batch`
    (memoryviews into one shared block); this single-frame entry returns
    bytes."""
    lib = _load_native()
    if lib:
        frame_b = bytes(frame)
        if len(frame_b) < 16:
            raise ValueError("truncated blosc frame")
        nbytes = struct.unpack("<I", frame_b[4:8])[0]
        code = (frame_b[2] >> 5) & 0x07
        if code in (0, 1, 2, 4) or frame_b[2] & 0x02:
            dst = np.empty(max(nbytes, 1), np.uint8)
            n = lib.blosc1_decompress(
                frame_b, len(frame_b), ctypes.c_char_p(dst.ctypes.data),
                nbytes,
            )
            if n == nbytes:
                return dst[:nbytes].tobytes()
    return decompress_py(frame)


# ---------------------------------------------------------------------------
# The system c-blosc, an interop oracle (tests, reading foreign frames)
# ---------------------------------------------------------------------------


_libblosc = None


def load_system_blosc():
    """A ctypes handle to the system c-blosc, or None when it is absent."""
    global _libblosc
    if _libblosc is not None:
        return _libblosc or None
    path = ctypes.util.find_library("blosc") or "libblosc.so.1"
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _libblosc = False
        return None
    lib.blosc_compress_ctx.restype = ctypes.c_int
    lib.blosc_compress_ctx.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_int]
    lib.blosc_decompress_ctx.restype = ctypes.c_int
    lib.blosc_decompress_ctx.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    _libblosc = lib
    return lib


def system_compress(data: bytes, typesize: int, clevel=3, shuffle=SHUFFLE,
                    cname="zstd") -> bytes:
    """A blosc frame of ``data`` from the system c-blosc (RuntimeError when
    it is absent or fails)."""
    lib = load_system_blosc()
    if lib is None:
        raise RuntimeError("system libblosc unavailable")
    dst = ctypes.create_string_buffer(len(data) + 1024)
    n = lib.blosc_compress_ctx(clevel, shuffle, typesize, len(data), data,
                               dst, len(dst), cname.encode(), 0, 1)
    if n <= 0:
        raise RuntimeError(f"libblosc compress failed: {n}")
    return dst.raw[:n]


def system_decompress(frame: bytes, nbytes: int) -> bytes:
    """The ``nbytes`` decoded by the system c-blosc from ``frame``
    (RuntimeError when it is absent or decodes another length)."""
    lib = load_system_blosc()
    if lib is None:
        raise RuntimeError("system libblosc unavailable")
    dst = ctypes.create_string_buffer(max(nbytes, 1))
    n = lib.blosc_decompress_ctx(frame, dst, nbytes, 1)
    if n != nbytes:
        raise RuntimeError(
            f"libblosc decompress returned {n}, expected {nbytes}")
    return dst.raw[:nbytes]
