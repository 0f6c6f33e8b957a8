"""
Image file writers (reference: destriper.py:49-110 ``imsave``).

Same behavior surface: tiff default (with level-N deflate compression, the
reference's ``compressionargs={"level": N}``), png when requested,
``.raw``/``.png`` inputs re-extensioned to ``.tiff`` when no explicit
output format is given. TIFF goes through the in-repo writer
(``io.tiff.tiff_imwrite``); imageio only for png.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

SUPPORTED_OUTPUT_EXTENSIONS = [".tif", ".tiff", ".png"]


def _get_extension(path) -> str:
    return Path(path).suffix


def _write_tiff(path: str, img: np.ndarray, compression: int = 1):
    from .tiff import tiff_imwrite

    level = int(compression) if compression and compression > 0 else None
    tiff_imwrite(path, np.asarray(img), compression_level=level)


def imsave(
    path,
    img: np.ndarray,
    compression: int = 1,
    output_format: Optional[str] = None,
):
    """Save ``img`` inferring the format from ``path`` or ``output_format``."""
    extension = _get_extension(path)

    if output_format is None:
        if extension in (".raw", ".png", ".tif", ".tiff"):
            _write_tiff(os.path.splitext(str(path))[0] + ".tiff", img, compression)
        else:
            raise NotImplementedError(
                f"We can't save in {extension} format, "
                f"available: {SUPPORTED_OUTPUT_EXTENSIONS}"
            )
        return

    if output_format not in SUPPORTED_OUTPUT_EXTENSIONS:
        raise ValueError(
            f"Output format {output_format} is not valid! "
            f"Supported extensions are: {SUPPORTED_OUTPUT_EXTENSIONS}"
        )

    filename = os.path.splitext(str(path))[0] + output_format
    if output_format in (".tif", ".tiff"):
        _write_tiff(filename, img, compression)
    elif output_format == ".png":
        import imageio

        imageio.v3.imwrite(filename, np.asarray(img), compress_level=compression)
