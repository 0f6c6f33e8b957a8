"""
File-batch destriping of a directory tree of TIFF/PNG/RAW planes.

Counterpart of ``aind_smartspim_destripe_tpu/destriper.py``. Files are read
by IO threads, grouped by (shape, dtype), destriped on one CUDA device in
batches of ``chunks`` planes, and written by IO threads; ``workers`` bounds
the IO thread pool. Each geometry gets one plan and one set of operator
tensors resident on the device for the whole run. Every device launch
comes from the calling thread: a thread per device loses to the
interpreter lock. Failed reads are retried three times, then logged to
``destripe_log.txt`` and skipped; writes retry ten times on OSError.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .filtering import filter_stripes
from .io.readers import SUPPORTED_READING_EXTENSIONS, imread
from .io.writers import imsave
from .ops.dual_band import dual_band_destripe_batch
from .ops.filter import (
    FilterConfig,
    build_plan,
    destripe_batch,
    device_constants,
    f32_matmul,
)
from .ops.flatfield import flatfield_correction, get_hemisphere_flatfield
from .parallel.mesh import one_device

__all__ = ["read_filter_save", "batch_filter"]

logger = logging.getLogger(__name__)
logger.setLevel(logging.INFO)


def read_filter_save(
    output_dir,
    input_path,
    output_path,
    high_int_filter_params: dict,
    low_int_filter_params: dict,
    shadow_correction: dict,
    compression: Optional[int] = 1,
    output_format: Optional[str] = None,
    output_dtype: Optional[type] = None,
    dual_band: Optional[dict] = None,
    device=None,
):
    """Read one image, destripe it on ``device``, save it: 3 read attempts
    then log-and-skip; 10 write retries on OSError.

    ``dual_band``: optional dict (``crossover`` / ``threshold`` keys) —
    blend both filter configs per pixel instead of the classifier."""
    raw_image = None
    for attempt in range(3):
        try:
            raw_image = imread(input_path)
            if raw_image is None:
                raise ValueError(f"unsupported input {input_path}")
            break
        except Exception:
            if attempt == 2:
                _log_failed_read(output_dir, input_path)
                return
            time.sleep(0.05)

    dtype = raw_image.dtype
    if output_dtype is not None and isinstance(output_dtype, type):
        dtype = output_dtype

    filtered_image = filter_stripes(
        image=np.asarray(raw_image),
        input_tile_path=input_path,
        no_cells_config=low_int_filter_params,
        cells_config=high_int_filter_params,
        shadow_correction=shadow_correction,
        dual_band=dual_band,
        device=device,
    )
    _write(output_dir, output_path, filtered_image.astype(dtype), compression,
           output_format)


def _write(output_dir, path, img, compression, output_format):
    """imsave with 10 attempts on OSError; the last failure is logged to
    ``destripe_log.txt``, so a clean log means every file was written."""
    for attempt in range(10):
        try:
            imsave(path, img, compression=compression,
                   output_format=output_format)
        except OSError:
            if attempt == 9:
                logger.error(f"FAILED writing image in {path}")
                _log_failed_read(output_dir, f"WRITE-FAILED {path}")
                return
            logger.error(f"Retrying writing image in {path}...")
            time.sleep(0.05)
            continue
        break


_log_lock = threading.Lock()


def _log_failed_read(output_dir, input_path):
    file_name = os.path.join(output_dir, "destripe_log.txt")
    with _log_lock:
        # concurrent IO-pool failures must not race the header check into a
        # truncating re-open that erases an already-logged path
        if not os.path.exists(file_name):
            with open(file_name, "w") as f:
                f.write(
                    "Error reading the following images.  "
                    "We will interpolate their content."
                )
        with open(file_name, "a+") as f:
            f.write(f"\n{input_path}")


def _find_all_images(search_path, input_path, output_path):
    """Recursively collect supported images, mirroring the directory tree
    into the output."""
    input_path = Path(input_path)
    output_path = Path(output_path)
    search_path = Path(search_path)
    if not search_path.is_dir():
        raise NotADirectoryError(f"not a directory: {search_path}")

    img_paths = []
    for p in search_path.iterdir():
        if p.is_file():
            if p.suffix in SUPPORTED_READING_EXTENSIONS:
                img_paths.append(p)
        elif p.is_dir():
            o = output_path.joinpath(p.relative_to(input_path))
            if not o.exists():
                o.mkdir(parents=True)
            img_paths.extend(_find_all_images(p, input_path, output_path))
    return img_paths


def batch_filter(
    input_path,
    output_path,
    workers: int,
    chunks: int,
    high_int_filt_params: dict,
    low_int_filt_params: dict,
    shadow_correction: dict,
    compression: Optional[int] = 1,
    output_format: Optional[str] = None,
    output_dtype: Optional[type] = None,
    dual_band: Optional[dict] = None,
    device=None,
):
    """Destripe a directory tree of images on ``device`` (None: the
    current CUDA device; raises without one).

    Images are grouped by (shape, dtype); each group runs through the
    destripe step in batches of ``chunks``, with threaded file IO around
    it; the groups' tails run last. Images that are not 2-D take the
    per-image path (:func:`read_filter_save`). ``dual_band``: optional dict
    (``crossover`` / ``threshold`` keys) — blend both filter configs per
    pixel (high_int = foreground band, low_int = background) instead of
    the per-plane classifier."""
    dev = one_device(device)
    f32_matmul()
    input_path = Path(input_path)
    output_path = Path(output_path)

    error_path = os.path.join(output_path, "destripe_log.txt")
    if os.path.exists(error_path):
        os.remove(error_path)

    logger.info(f"Looking for images in {input_path}")
    img_paths = _find_all_images(input_path, input_path, output_path)
    logger.info(f"Found {len(img_paths)} compatible images")

    for file in input_path.iterdir():
        if Path(file).suffix in [".txt", ".ini"]:
            shutil.copyfile(file, os.path.join(output_path, os.path.split(file)[1]))

    n_io = max(1, int(workers) or 1)
    batch = max(1, int(chunks) or 1)
    logger.info(f"Setting up {n_io} io threads, device batch {batch} on {dev}")

    cells_cfg = FilterConfig.from_dict(high_int_filt_params or {})
    no_cells_cfg = FilterConfig.from_dict(low_int_filt_params or {})

    io_pool = ThreadPoolExecutor(max_workers=n_io)

    # bounded memory: at most ``read_ahead`` decoded images wait for the
    # device, one partial bucket per geometry, and at most ``max_writes``
    # images wait for disk
    read_ahead = max(2 * batch, 2 * n_io)
    max_writes = 4 * n_io

    def read_one(p):
        for attempt in range(3):
            try:
                img = imread(p)
                if img is None:
                    raise ValueError(f"unsupported input {p}")
                return p, np.asarray(img)
            except Exception:
                if attempt == 2:
                    _log_failed_read(output_path, p)
                    return p, None
                time.sleep(0.05)

    geometries = {}  # shape -> (plan, its operator tensors on dev)
    write_futures = deque()

    def geometry(shape):
        if shape not in geometries:
            plan = build_plan(shape[0], shape[1], cells_cfg, no_cells_cfg)
            geometries[shape] = (
                plan, device_constants(plan, dev))
        return geometries[shape]

    def corrected(plane, p):
        """The plane's shadow correction on the device, or the plane."""
        if shadow_correction is None:
            return plane
        flat = shadow_correction.get("flatfield")
        dark = shadow_correction.get("darkfield")
        if flat is None:
            # the dark only applies inside the flat-field correction
            logger.warning(
                "shadow_correction without a flatfield — skipping "
                "the correction (dark alone cannot apply)"
            )
            return plane
        if not shadow_correction.get("retrospective"):
            flat = get_hemisphere_flatfield(
                input_tile_path=p,
                tile_config=shadow_correction.get("tile_config"),
                flatfields=flat,
                zarr=False,
            )
        return flatfield_correction(
            plane, torch.as_tensor(np.asarray(flat), device=dev),
            torch.as_tensor(np.asarray(dark), device=dev))

    def process_batch(shape, items):
        plan, consts = geometry(shape)
        imgs = np.stack([im for _, im in items])
        if imgs.dtype != np.uint16:  # uint16 ships raw; the kernels read it
            imgs = imgs.astype(np.float32)
        x = torch.as_tensor(imgs, device=dev)
        with torch.inference_mode():
            if dual_band is not None:
                filtered = dual_band_destripe_batch(
                    plan, x,
                    crossover=float(dual_band.get("crossover", 100.0)),
                    threshold=float(dual_band.get("threshold", -1.0)),
                    consts=consts)
            else:
                filtered = destripe_batch(plan, x, 2700.0, consts)
            planes = [corrected(filtered[i], p).cpu().numpy()
                      for i, (p, _) in enumerate(items)]
        del x, filtered

        for (p, img), out_img in zip(items, planes):
            dtype_out = output_dtype if isinstance(output_dtype, type) else img.dtype
            o = output_path.joinpath(Path(p).relative_to(input_path))
            write_futures.append(io_pool.submit(
                _write, output_path, o, out_img.astype(dtype_out),
                compression, output_format))
        while len(write_futures) > max_writes:
            write_futures.popleft().result()

    groups = defaultdict(list)  # (shape, dtype) -> partial bucket, < batch items
    pending_reads = deque()
    path_iter = iter(img_paths)

    def schedule_reads():
        while len(pending_reads) < read_ahead:
            p = next(path_iter, None)
            if p is None:
                return
            pending_reads.append(io_pool.submit(read_one, p))

    try:
        schedule_reads()
        while pending_reads:
            p, img = pending_reads.popleft().result()
            schedule_reads()
            if img is None:
                continue
            if img.ndim != 2:
                # odd inputs (e.g. RGB pngs) take the per-image path
                o = output_path.joinpath(Path(p).relative_to(input_path))
                read_filter_save(
                    output_path, p, o, high_int_filt_params,
                    low_int_filt_params, shadow_correction, compression,
                    output_format, output_dtype, dual_band=dual_band,
                    device=dev,
                )
                continue
            key = (img.shape, img.dtype)
            groups[key].append((p, img))
            if len(groups[key]) == batch:
                process_batch(key[0], groups.pop(key))

        for (shape, _), items in groups.items():  # tail buckets
            process_batch(shape, items)

        for f in write_futures:
            f.result()
    finally:
        io_pool.shutdown()

    logger.info("Done with batch filtering!")
    if os.path.exists(error_path):
        logger.error("An error happened, see destripe log for more details")
