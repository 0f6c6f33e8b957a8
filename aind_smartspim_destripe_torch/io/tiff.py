"""
Minimal TIFF reader/writer: classic TIFF and BigTIFF, multi-page, grayscale.

Closes the round-1 input-compat gap vs the reference's ``tifffile.imread``
(reference readers.py:85): multi-page stacks (e.g. acquisition flats saved
as a stack) and BigTIFF files (>4 GB masters) now read correctly instead of
silently returning page 1 or failing. tifffile itself is not part of this
runtime; PIL remains the fast path for classic single/multi-page files and
this parser handles what PIL cannot (BigTIFF) or misparses.

Scope (grayscale scientific TIFF): strip-based layout, 8/16/32-bit unsigned
/signed/float samples, compression None/Deflate/PackBits/LZW, horizontal
predictor, II and MM byte orders, classic and BigTIFF containers. Tiled or
multi-sample (RGB) files fall back to PIL with a clear error otherwise.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["tiff_imread", "tiff_imwrite", "is_bigtiff"]

# tag ids
_WIDTH, _LENGTH = 256, 257
_BITS, _COMPRESSION, _PHOTOMETRIC = 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 277, 278, 279
_PREDICTOR, _SAMPLE_FORMAT = 317, 339
_TILE_WIDTH = 322

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def is_bigtiff(path) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) < 4 or head[:2] not in (b"II", b"MM"):
        return False
    bo = "<" if head[:2] == b"II" else ">"
    return struct.unpack(bo + "H", head[2:4])[0] == 43


def _read_values(data, bo, ftype, count, inline, inline_size):
    fmt = _TYPE_FMT.get(ftype)
    if fmt is None:
        return None
    size = _TYPE_SIZE[ftype] * count
    # bound BEFORE building anything sized by count: a corrupt count field
    # (u32/u64 garbage) must raise, not allocate O(count) — the old
    # `fmt * count` format string burned seconds and up to GBs on a
    # single flipped IFD byte before struct.unpack even saw the short raw
    if size > len(data):
        raise ValueError(
            f"TIFF tag value count {count} (type {ftype}) exceeds file size"
        )
    if size <= inline_size:
        raw = inline[:size]
    else:
        (off,) = struct.unpack(bo + ("Q" if inline_size == 8 else "I"), inline)
        raw = data[off : off + size]
    if len(raw) != size:
        raise ValueError("TIFF tag values truncated")
    # repeat-count format syntax: constant-size format string
    return struct.unpack(bo + f"{count}{fmt}", raw)


def _unpack_at(bo: str, fmt: str, data: bytes, off: int):
    """struct.unpack at an offset with the truncation contract: a header /
    IFD offset pointing past EOF (fuzz-reachable with one flipped byte)
    raises ValueError like every other malformed-TIFF path, never
    struct.error."""
    size = struct.calcsize(fmt)
    raw = data[off : off + size]
    if len(raw) != size:
        raise ValueError("truncated TIFF structure")
    return struct.unpack(bo + fmt, raw)


def _parse_ifds(data: bytes):
    """Yield (byte_order, {tag: values}) per IFD for classic or BigTIFF."""
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("not a TIFF file")
    (magic,) = _unpack_at(bo, "H", data, 2)
    if magic == 42:
        big = False
        (ifd_off,) = _unpack_at(bo, "I", data, 4)
        entry_size, count_fmt, off_fmt, inline_size = 12, "H", "I", 4
    elif magic == 43:
        big = True
        offsize, zero = _unpack_at(bo, "HH", data, 4)
        if offsize != 8 or zero != 0:
            raise ValueError("malformed BigTIFF header")
        (ifd_off,) = _unpack_at(bo, "Q", data, 8)
        entry_size, count_fmt, off_fmt, inline_size = 20, "Q", "Q", 8
    else:
        raise ValueError(f"bad TIFF magic {magic}")

    ifds = []
    seen = set()
    while ifd_off and ifd_off not in seen:
        seen.add(ifd_off)
        (n_entries,) = _unpack_at(bo, count_fmt, data, ifd_off)
        pos = ifd_off + struct.calcsize(count_fmt)
        tags = {}
        for _ in range(n_entries):
            entry = data[pos : pos + entry_size]
            if len(entry) != entry_size:
                raise ValueError("truncated TIFF IFD entry")
            pos += entry_size
            tag, ftype = struct.unpack(bo + "HH", entry[:4])
            if big:
                (cnt,) = struct.unpack(bo + "Q", entry[4:12])
                inline = entry[12:20]
            else:
                (cnt,) = struct.unpack(bo + "I", entry[4:8])
                inline = entry[8:12]
            vals = _read_values(data, bo, ftype, cnt, inline, inline_size)
            if vals is not None:
                tags[tag] = vals
        (ifd_off,) = _unpack_at(bo, off_fmt, data, pos)
        ifds.append((bo, tags))
    return ifds


def _unpackbits_decode(raw: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw) and len(out) < expected:
        n = raw[i]
        i += 1
        if n < 128:
            out += raw[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += raw[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _lzw_decode(raw: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early code-width change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []
    bitpos = 0
    nbits = 9
    prev: Optional[bytes] = None
    total_bits = len(raw) * 8

    def reset():
        nonlocal table, nbits, prev
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        nbits = 9
        prev = None

    reset()
    while bitpos + nbits <= total_bits and len(out) < expected:
        byte0 = bitpos // 8
        chunk = raw[byte0 : byte0 + 4].ljust(4, b"\0")
        word = int.from_bytes(chunk, "big")
        code = (word >> (32 - nbits - (bitpos % 8))) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == CLEAR:
            reset()
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # early change: width bumps one code before the table fills
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(out)


def _decode_page(data: bytes, bo: str, tags: dict) -> np.ndarray:
    if _TILE_WIDTH in tags:
        raise ValueError("tiled TIFF not supported by the native parser")
    samples = tags.get(_SAMPLES, (1,))[0]
    if samples != 1:
        raise ValueError(f"only 1 sample/pixel supported, got {samples}")
    for req in (_WIDTH, _LENGTH, _STRIP_OFFSETS, _STRIP_COUNTS):
        # fuzz-reachable: one flipped tag id drops a required entry — the
        # contract is ValueError for every malformed file, never KeyError
        if req not in tags:
            raise ValueError(f"TIFF page missing required tag {req}")
    width = tags[_WIDTH][0]
    length = tags[_LENGTH][0]
    bits = tags.get(_BITS, (1,))[0]
    comp = tags.get(_COMPRESSION, (1,))[0]
    sfmt = tags.get(_SAMPLE_FORMAT, (1,))[0]
    predictor = tags.get(_PREDICTOR, (1,))[0]
    kind = {1: "u", 2: "i", 3: "f"}.get(sfmt)
    if kind is None or bits not in (8, 16, 32, 64):
        raise ValueError(f"unsupported sample format {sfmt}/{bits}")
    dtype = np.dtype(f"{bo}{kind}{bits // 8}")

    offsets = tags[_STRIP_OFFSETS]
    counts = tags[_STRIP_COUNTS]
    rows_per_strip = tags.get(_ROWS_PER_STRIP, (length,))[0]
    row_bytes = width * bits // 8
    # corrupt dimension fields must raise, not allocate: a flipped byte in
    # ImageLength/RowsPerStrip would otherwise drive multi-GB ljust/buffer
    # growth below (4 GiB dwarfs any real microscopy page)
    if length * row_bytes > (1 << 32):
        raise ValueError(
            f"TIFF page {length}x{width}x{bits}b exceeds the 4 GiB page bound"
        )

    buf = bytearray()
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        nrows = min(rows_per_strip, length - i * rows_per_strip)
        expected = nrows * row_bytes
        if expected <= 0:
            # surplus/zero-row strip entries decode to nothing; the final
            # frombuffer length check raises if real rows went missing.
            # Skipping also keeps the deflate bound meaningful: zlib treats
            # max_length=0 as UNLIMITED (the zip-bomb hole this bound closes)
            continue
        raw = data[off : off + cnt]
        if comp == 1:
            seg = raw[:expected]
        elif comp in (8, 32946):  # deflate — bound inflation at the strip's
            # expected size (a crafted frame can expand far past it before
            # an unbounded decompress returns; same contract as io/blosc)
            try:
                seg = zlib.decompressobj().decompress(bytes(raw), expected)
            except zlib.error as e:  # malformed-TIFF contract: ValueError
                raise ValueError(f"corrupt deflate strip: {e}") from None
        elif comp == 32773:  # packbits
            seg = _unpackbits_decode(raw, expected)
        elif comp == 5:  # lzw
            seg = _lzw_decode(raw, expected)
        else:
            raise ValueError(f"unsupported TIFF compression {comp}")
        if len(seg) < expected:
            seg = seg.ljust(expected, b"\0")
        buf += seg

    img = np.frombuffer(bytes(buf), dtype=dtype, count=length * width)
    img = img.reshape(length, width)
    if predictor == 2:
        img = np.cumsum(img.astype(np.int64), axis=1).astype(dtype)
    return img.astype(img.dtype.newbyteorder("="))


def _native_read(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    pages = [_decode_page(data, bo, tags) for bo, tags in _parse_ifds(data)]
    if not pages:
        raise ValueError("TIFF has no images")
    if len(pages) == 1:
        return pages[0]
    if any(p.shape != pages[0].shape or p.dtype != pages[0].dtype for p in pages):
        raise ValueError("multi-page TIFF with inconsistent page geometry")
    return np.stack(pages)


def _pil_read(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        n = getattr(im, "n_frames", 1)
        if n <= 1:
            return np.asarray(im)
        pages = []
        for i in range(n):
            im.seek(i)
            pages.append(np.asarray(im))
    return np.stack(pages)


def tiff_imread(path) -> np.ndarray:
    """Read a TIFF: (h, w) for single page, (n, h, w) for multi-page stacks
    (tifffile.imread semantics). BigTIFF goes through the native parser
    (PIL cannot read it); classic files use PIL with native fallback."""
    if is_bigtiff(path):
        return _native_read(path)
    try:
        return _pil_read(path)
    except Exception:
        return _native_read(path)


def _page_payload(bo, arr, compression_level=None):
    """One full-page strip, optionally Adobe-deflate compressed."""
    raw = arr.astype(arr.dtype.newbyteorder(bo)).tobytes()
    if compression_level is None:
        return raw, 1
    import zlib

    return zlib.compress(raw, compression_level), 8


def _build_page_ifd(bo, big, arr, data_offset, payload_len, comp_tag):
    """ifd_bytes_without_next for one page whose strip payload is
    ``payload_len`` bytes at ``data_offset``."""
    h, w = arr.shape
    kind = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]

    tags = [
        (_WIDTH, 4, 1, w),
        (_LENGTH, 4, 1, h),
        (_BITS, 3, 1, arr.dtype.itemsize * 8),
        (_COMPRESSION, 3, 1, comp_tag),
        (_PHOTOMETRIC, 3, 1, 1),
        (_STRIP_OFFSETS, 16 if big else 4, 1, data_offset),
        (_SAMPLES, 3, 1, 1),
        (_ROWS_PER_STRIP, 4, 1, h),
        (_STRIP_COUNTS, 16 if big else 4, 1, payload_len),
        (_SAMPLE_FORMAT, 3, 1, kind),
    ]
    if big:
        out = struct.pack(bo + "Q", len(tags))
        for tag, ftype, cnt, val in tags:
            out += struct.pack(bo + "HHQ", tag, ftype, cnt)
            out += struct.pack(bo + "Q", val)
    else:
        out = struct.pack(bo + "H", len(tags))
        for tag, ftype, cnt, val in tags:
            out += struct.pack(bo + "HHI", tag, ftype, cnt)
            out += struct.pack(bo + "I", val)
    return out


def tiff_imwrite(
    path,
    img: np.ndarray,
    bigtiff: Optional[bool] = None,
    compression_level: Optional[int] = None,
):
    """Write a grayscale TIFF. ``img``: (h, w) or (n, h, w) multi-page.
    ``compression_level`` None -> uncompressed strips; 1..9 -> Adobe
    deflate at that zlib level (the reference's
    ``compressionargs={"level": N}``, destriper.py:75-87). BigTIFF is
    chosen automatically above 3.5 GB or forced via ``bigtiff=True``."""
    img = np.asarray(img)
    pages = img[None] if img.ndim == 2 else img
    if pages.ndim != 3:
        raise ValueError(f"expected 2-D or 3-D image, got {img.shape}")
    if bigtiff is None:
        bigtiff = pages.nbytes > int(3.5 * 2**30)
    bo = "<"

    if bigtiff:
        header_size = 16
        next_fmt = "Q"
        ifd_size = struct.calcsize("Q") + 20 * 10 + struct.calcsize("Q")
    else:
        header_size = 8
        next_fmt = "I"
        ifd_size = struct.calcsize("H") + 12 * 10 + struct.calcsize("I")

    # layout: header | page payloads | IFD chain. Uncompressed payloads are
    # emitted per page while writing (their length is just p.nbytes — a
    # multi-GB stack must not be duplicated in memory); only compressed
    # payloads (small) are materialized up front to learn their sizes.
    if compression_level is None:
        payloads = None
        payload_lens = [int(p.nbytes) for p in pages]
        comp_tags = [1] * len(pages)
    else:
        payloads, comp_tags = [], []
        for p in pages:
            payload, comp_tag = _page_payload(bo, p, compression_level)
            payloads.append(payload)
            comp_tags.append(comp_tag)
        payload_lens = [len(pl) for pl in payloads]
    payload_offsets = []
    pos = header_size
    for n in payload_lens:
        payload_offsets.append(pos)
        pos += n
    ifd_offsets = [pos + i * ifd_size for i in range(len(pages))]

    with open(path, "wb") as f:
        if bigtiff:
            f.write(b"II" + struct.pack(bo + "H", 43) + struct.pack(bo + "HH", 8, 0)
                    + struct.pack(bo + "Q", ifd_offsets[0]))
        else:
            f.write(b"II" + struct.pack(bo + "H", 42) + struct.pack(bo + "I", ifd_offsets[0]))
        if payloads is None:
            for p in pages:
                f.write(_page_payload(bo, p)[0])
        else:
            for payload in payloads:
                f.write(payload)
        for i, (p, off) in enumerate(zip(pages, payload_offsets)):
            ifd = _build_page_ifd(bo, bigtiff, p, off, payload_lens[i], comp_tags[i])
            nxt = ifd_offsets[i + 1] if i + 1 < len(pages) else 0
            f.write(ifd + struct.pack(bo + next_fmt, nxt))
