"""
Image file readers (reference: code/aind_smartspim_destripe/readers.py).

Same surface — ``imread`` dispatching on extension, ``raw_imread`` with the
8-byte width/height header and endianness heuristic — but built on
imageio/PIL (tifffile is not part of this runtime; PIL handles the uint16
grayscale TIFFs SmartSPIM produces).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

PathLike = Union[Path, str]

SUPPORTED_READING_EXTENSIONS = [".tif", ".tiff", ".raw", ".png"]


def _get_extension(path: PathLike) -> str:
    return Path(path).suffix


def raw_imread(path: PathLike) -> np.ndarray:
    """Memory-map a SmartSPIM ``.raw`` image: two u32 header words
    (width, height) followed by u2 pixels. Endianness is detected by assuming
    the smaller decoded width is correct (valid for widths < 64K), matching
    the reference heuristic (readers.py:34-61)."""
    header_be = np.memmap(path, dtype=">u4", mode="r", shape=(2,))
    width_be, height_be = (int(x) for x in header_be[:2])
    del header_be
    header_le = np.memmap(path, dtype="<u4", mode="r", shape=(2,))
    width_le, height_le = (int(x) for x in header_le[:2])
    del header_le

    if width_le < width_be:
        width, height, dtype = width_le, height_le, "<u2"
    else:
        width, height, dtype = width_be, height_be, ">u2"

    try:
        return np.memmap(path, dtype=dtype, mode="r", offset=8, shape=(width, height))
    except Exception:
        print(f"Bad path: {path}")
        raise


def imread(path: PathLike) -> np.ndarray:
    """Load a .tif/.tiff/.raw/.png image (readers.py:64-89 surface)."""
    path = str(path)
    extension = _get_extension(path)
    if extension == ".raw":
        return raw_imread(path)
    if extension in (".tif", ".tiff"):
        # multi-page stacks and BigTIFF included (tifffile.imread semantics,
        # reference readers.py:85) — see io/tiff.py
        from .tiff import tiff_imread

        return tiff_imread(path)
    if extension == ".png":
        import imageio

        return np.asarray(imageio.v3.imread(path))
    return None
