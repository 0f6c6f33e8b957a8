"""
Flat-field / dark-field / baseline estimation from sample slides.

Counterpart of ``aind_smartspim_destripe_tpu/flatfield_estimation.py``:
``shading_correction`` (fit the BaSiC shading model over destriped tiles),
``unify_fields`` (median / mean / mip combination, float16 cast) and
``slide_flat_estimation`` (walk the SmartSPIM col/row tree, destripe every
tile of a slide as one device batch, fit per slide), with the BaSiC model
of :mod:`.models.basic` on the same device.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from .io.readers import imread
from .models.basic import BaSiC
from .parallel.mesh import one_device

__all__ = ["shading_correction", "unify_fields", "slide_flat_estimation"]


def shading_correction(
    slides: List[np.ndarray],
    shading_parameters: dict,
    mask: Optional[np.ndarray] = None,
    device=None,
) -> dict:
    """Fit the shading model over a stack of (destriped) tiles on
    ``device`` (None: the current CUDA device)."""
    shading_obj = BaSiC(**shading_parameters, device=device)
    shading_obj.fit(images=np.array(slides), fitting_weight=mask)
    return {
        "flatfield": shading_obj.flatfield,
        "darkfield": shading_obj.darkfield,
        "baseline": shading_obj.baseline,
    }


def unify_fields(
    flatfields: List[np.ndarray],
    darkfields: List[np.ndarray],
    baselines: List[np.ndarray],
    mode: Optional[str] = "median",
):
    """Combine per-slide fits into single float16 fields."""
    flatfields = np.array(flatfields)
    darkfields = np.array(darkfields)
    baselines = np.array(baselines)

    if mode == "median":
        flatfield = np.median(flatfields, axis=0)
        darkfield = np.median(darkfields, axis=0)
        baseline = np.median(baselines, axis=0)
    elif mode == "mean":
        flatfield = np.mean(flatfields, axis=0)
        darkfield = np.mean(darkfields, axis=0)
        baseline = np.mean(baselines, axis=0)
    elif mode == "mip":
        flatfield = np.max(flatfields, axis=0)
        darkfield = np.min(darkfields, axis=0)
        baseline = np.max(baselines, axis=0)
    else:
        raise NotImplementedError("Accepted values are: ['mean', 'median', 'mip']")

    return (
        flatfield.astype(np.float16),
        darkfield.astype(np.float16),
        baseline.astype(np.float16),
    )


def slide_flat_estimation(
    dict_struct: dict,
    channel_name: str,
    slide_idxs: List[int],
    shading_parameters: dict,
    no_cells_config: dict,
    cells_config: dict,
    device=None,
) -> dict:
    """Per-slide shading fits over the destriped tiles of a SmartSPIM
    channel tree (``dict_struct``: the output of
    ``utils.read_image_directory_structure``), on ``device`` (None: the
    current CUDA device; raises without one).

    Every tile of a slide is read by 8 IO threads and destriped as one
    device batch (the tiles of a slide share their geometry), with
    ``microscope_high_int`` 2700, the per-plane default of
    ``filter_stripes``; the fit then runs on the destriped batch where it
    lies. Each slide's entry holds the fields, the destriped tiles (numpy)
    under ``"data"``, the host seconds of both stages under ``"seconds"``
    (``"destripe"``, ``"fit"``) and the fit's host reads under
    ``"host_syncs"``."""
    from .ops.filter import (
        FilterConfig,
        build_plan,
        destripe_batch,
        device_constants,
        f32_matmul,
    )

    dev = one_device(device)
    f32_matmul()
    dict_struct = dict_struct[channel_name]
    cols = list(dict_struct.keys())
    rows = [row.split("_")[-1] for row in list(dict_struct[cols[0]].keys())]
    row_name = f"{cols[0]}_{rows[0]}"
    grid = [(col, row) for col in cols for row in rows]

    cells_cfg = FilterConfig.from_dict(cells_config or {})
    no_cells_cfg = FilterConfig.from_dict(no_cells_config or {})

    geometries = {}  # shape -> (plan, its operator tensors on dev)
    shading_correction_per_slide = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for slide_idx in slide_idxs:
            slide_name = dict_struct[cols[0]][row_name][slide_idx]
            paths = [
                f"{channel_name}/{col}/{col}_{row}/{slide_name}"
                for col, row in grid
            ]
            imgs = np.stack([np.asarray(d) for d in pool.map(imread, paths)])
            if imgs.dtype != np.uint16:  # uint16 ships raw; the kernels read it
                imgs = imgs.astype(np.float32)

            t0 = time.perf_counter()
            shape = imgs.shape[-2:]
            if shape not in geometries:
                plan = build_plan(shape[0], shape[1], cells_cfg, no_cells_cfg)
                geometries[shape] = (
                    plan, device_constants(plan, dev))
            plan, consts = geometries[shape]
            with torch.inference_mode():
                destriped = destripe_batch(
                    plan, torch.as_tensor(imgs, device=dev), 2700.0, consts)
            slide_tiles = list(destriped.cpu().numpy())
            t1 = time.perf_counter()
            model = BaSiC(**shading_parameters, device=dev).fit(destriped)
            shading_correction_per_slide[slide_idx] = {
                "flatfield": model.flatfield,
                "darkfield": model.darkfield,
                "baseline": model.baseline,
                "data": slide_tiles,
                "seconds": {"destripe": t1 - t0,
                            "fit": time.perf_counter() - t1},
                "host_syncs": model.host_syncs,
            }

    return shading_correction_per_slide
