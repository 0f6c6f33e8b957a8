"""
The destripe step in PyTorch: plan, classifier, per-level filter and the
batched log-space wavelet-FFT destripe.

Counterpart of ``aind_smartspim_destripe_tpu/ops/filter.py``. A *plan* is
built once per image geometry: the per-level shape ladder. The plane
step's constants on a device (:func:`device_constants`, the one builder)
hold the dense DWT operators, the packed-FFT notch operators and each
banded level's band forms, built from the wavelet's taps; on a card a
banded level holds its band forms alone, and the widest notch operators
are built there. Planes run as a batch (B, H, W):

- analysis keeps only the lowpass x half (only cA and cH are consumed);
- each cH band goes through Otsu mask -> row-median inpaint -> notch of the
  plane's configuration -> delta (:func:`.cuda_notch.notch_delta`;
  :func:`.cuda_notch.notch_delta_lowrank` at a level whose notch minus the
  identity has a small exact rank against its width, which holds
  :class:`.fft_notch.NotchFactors` in place of the dense bank;
  :func:`.cuda_notch.notch_delta_fft` at a wide level whose rank is not
  small, which holds :class:`.fft_notch.NotchChirp`, its chirp-z tables;
  its histogram through :func:`.cuda_hist.histogram256_batch`);
- synthesis propagates only the deltas, by perfect reconstruction, and
  adds them to ``log(1 + x)``, then ``exp(y) + 1``.

Levels whose input passes the band gate (:func:`band_gate`, the same rule
as the JAX package's) run their four passes through :mod:`.cuda_band`: the
Hopper kernels K1-K4 for CUDA tensors, their plain twins for CPU tensors.
K1 then takes the raw uint16 planes and emits the classifier's sums, K2 the
Otsu bin range, and K4 applies the uint16 epilogue. The DWT of every other
level is a product of dense operators in float32,
:func:`.cuda_dense.dense_matmul`: for CUDA tensors a kernel that sums in
one order at any batch size, so a plane's output does not depend on the
planes it came with; ``torch.matmul`` for CPU tensors. The tail of every
level (Otsu histogram, row median, notch) runs the kernels of
:mod:`.cuda_hist` and :mod:`.cuda_notch` for CUDA tensors and their plain
twins, the JAX package's dense formulation, for CPU tensors.

``dual=True`` (the dual-band mode) runs both of the plan's configurations
on every plane from one decomposition: analysis and Otsu once per plane,
then the wrapped median and notch kernels emit 2B deltas from B bands, and
synthesis runs on 2B planes, K4 reading raw plane ``b mod B``.

Replicated reference quirks (they define the golden output): ``exp(y) + 1``
as the inverse of log1p; the float16 sigmoid classifier (center 400,
crossover 20); notch sigma scaled by the level's row count over min(H, W);
packed FFTPACK notch gains.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime.tracing import add, span, timed
from . import cuda_band, cuda_dense, cuda_notch, fft_notch, wavelets
from .flatfield import flatfield_correction, wrap_cast
from .otsu import threshold_otsu_batch
from .wavelets import f32_matmul, wavedec2_shapes, wavelet

__all__ = [
    "FilterConfig",
    "DestripePlan",
    "build_plan",
    "band_gate",
    "device_constants",
    "destripe_batch",
    "classify_planes",
    "classify_from_sums",
    "classifier_sums",
    "log_space_fft_filtering",
    "normalize_flat_dark",
    "wrap_cast",
    "f32_matmul",
]

# Band gate of the JAX package (ops/filter.py band_spec): a level runs the
# banded kernels when its input has at least this many pixels and sides.
_BAND_MIN_PX = 400_000
_BAND_MIN_SIDE = 560

# span names per level, made once: a span's name is evaluated on every call
_SPAN_AN = tuple(f"an.L{lvl}" for lvl in range(32))
_SPAN_OTSU = tuple(f"otsu.L{lvl}" for lvl in range(32))
_SPAN_NOTCH = tuple(f"notch.L{lvl}" for lvl in range(32))
_SPAN_SYN = tuple(f"syn.L{lvl}" for lvl in range(32))


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FilterConfig:
    """Parameters of the reference log_space_fft_filtering."""

    wavelet: str = "db3"
    level: Optional[int] = None
    sigma: float = 64.0
    max_threshold: float = 4.0

    @staticmethod
    def from_dict(d: dict) -> "FilterConfig":
        return FilterConfig(
            wavelet=d.get("wavelet", "db3"),
            level=d.get("level", None),
            sigma=float(d.get("sigma", 64)),
            max_threshold=float(d.get("max_threshold", 4)),
        )


def band_gate(h: int, w: int) -> bool:
    """Does an analysis level with an (h, w) input run the banded kernels?"""
    return h * w >= _BAND_MIN_PX and h >= _BAND_MIN_SIDE and w >= _BAND_MIN_SIDE


@dataclass(frozen=True)
class DestripePlan:
    """Static description of a destripe computation for one image geometry
    and a (cells, no-cells) config pair."""

    height: int
    width: int
    wavelet: str
    n_levels: int
    ladder: Tuple[Tuple[int, int], ...]  # coarsest-first detail shapes
    cells: FilterConfig
    no_cells: FilterConfig

    def notch_matrices(self, dtype=np.float32, skip=None):
        """Per-level (cells, no_cells) notch operators, coarsest first, with
        sigma_effective = rows(level) * sigma / min(H, W). ``skip``:
        coarsest-first booleans; levels marked True get None instead of a
        pair, and their matrices are never built."""
        min_side = min(self.height, self.width)
        return tuple(
            None if skip is not None and skip[i] else tuple(
                fft_notch.packed_notch_matrix(
                    w, float(h * cfg.sigma / min_side)).astype(dtype)
                for cfg in (self.cells, self.no_cells)
            )
            for i, (h, w) in enumerate(self.ladder)
        )

    def notch_sigmas(self):
        """Per-level (cells, no_cells) effective notch sigmas, coarsest
        first."""
        min_side = min(self.height, self.width)
        return tuple(
            (h * self.cells.sigma / min_side, h * self.no_cells.sigma / min_side)
            for (h, _) in self.ladder
        )

    def notch_routes(self):
        """Per-level routes of the plane step's notch, coarsest first:
        ``"lowrank"`` (the factors), ``"chirp"`` (the chirp-z transforms)
        or ``"dense"`` (the (w, w) operators), by
        :func:`fft_notch.notch_route` of the width and the sigmas."""
        return tuple(fft_notch.notch_route(w, sigmas) for (_, w), sigmas in
                     zip(self.ladder, self.notch_sigmas()))

    def level_inputs(self):
        """The (h, w) input of each analysis level, finest first."""
        shapes = [(self.height, self.width)] + list(self.ladder[::-1])
        return shapes[:self.n_levels]

    def banded_levels(self) -> Tuple[int, ...]:
        """The levels that run the band kernels: the leading levels whose
        (h, w) input passes :func:`band_gate` (coarser levels only shrink,
        so the first miss ends the run)."""
        out = []
        for lvl, (h, w) in enumerate(self.level_inputs()):
            if not band_gate(h, w):
                break
            out.append(lvl)
        return tuple(out)


def device_constants(plan: DestripePlan, device) -> dict:
    """The constants the plane step reads on ``device``, as tensors there.
    Keys: ``an_y`` (2L_h x h) and ``an_x_lo`` (L_w x w), finest first;
    ``syn_y`` (h_t x 2L_h, rows trimmed to the crop-rule target),
    ``syn_x_lo`` (w_t x L_w) and ``notch_cat``, coarsest first; and
    ``band{lvl}``, the band forms of each banded level
    (:meth:`DestripePlan.banded_levels`), built from the wavelet's taps
    (:func:`cuda_band.band_level_forms_taps`).

    A banded level's four dense operators are None on a card, never
    built: the band kernels read the band forms alone. Off the card they
    are built, since the plain twins of the band kernels read them. A
    level's ``notch_cat`` follows :meth:`DestripePlan.notch_routes`: its
    :class:`fft_notch.NotchFactors` (:func:`fft_notch.notch_factors`) on
    the ``"lowrank"`` route, counted in ``plan.notch_lowrank_levels``; its
    :class:`fft_notch.NotchChirp` (:func:`fft_notch.notch_chirp`) on the
    ``"chirp"`` route, counted in ``plan.notch_fft_levels``; elsewhere the
    dense bank (:func:`fft_notch.notch_cat`: the cells and
    no-cells operators side by side, (w, 2w)), built on a card past
    :data:`fft_notch.NOTCH_HOST_MAX_W` columns. Counts the bytes put on a
    card in ``plan.device_bytes``."""
    device = torch.device(device)
    return _upload(_build_constants(plan, device), device)


def _build_constants(plan: DestripePlan, device: torch.device) -> dict:
    """:func:`device_constants` before the upload: numpy arrays, and the
    notch banks built on a card as tensors there."""
    with timed("plan.constants"):
        banded = plan.banded_levels()
        skip = banded if device.type == "cuda" else ()
        out = _dwt_operators(plan, skip, skip)
        with span("plan.notch"):
            routes = plan.notch_routes()
            build = {"lowrank": fft_notch.notch_factors,
                     "chirp": fft_notch.notch_chirp,
                     "dense": partial(fft_notch.notch_cat, device=device)}
            out["notch_cat"] = tuple(
                build[route](w, sigmas) for route, (_, w), sigmas in zip(
                    routes, plan.ladder, plan.notch_sigmas()))
            add("plan.notch_lowrank_levels", routes.count("lowrank"))
            add("plan.notch_fft_levels", routes.count("chirp"))
            if any(isinstance(c, torch.Tensor) for c in out["notch_cat"]):
                torch.cuda.synchronize(device)  # its time is set-up's
        with span("plan.band_forms"):
            inputs = plan.level_inputs()
            out.update({f"band{lvl}": cuda_band.band_level_forms_taps(
                *inputs[lvl], plan.wavelet) for lvl in banded})
        return out


def _dwt_operators(plan: DestripePlan, no_y=(), no_x=()) -> dict:
    """The plan's dense DWT operators, numpy float32: ``an_y`` (2L_h x h)
    and ``an_x_lo`` (L_w x w), finest first; ``syn_y`` (h_t x 2L_h, rows
    trimmed to the crop-rule target) and ``syn_x_lo`` (w_t x L_w),
    coarsest first. The levels in ``no_y`` (``no_x``) get None for their
    y (x) pair, never built."""
    name, n = plan.wavelet, plan.n_levels
    an, syn = [], []  # finest first
    for lvl, (h, w) in enumerate(plan.level_inputs()):
        L_h, L_w = plan.ladder[n - 1 - lvl]
        y, x = lvl not in no_y, lvl not in no_x
        an.append((
            wavelets.analysis_operator(h, name) if y else None,
            wavelets.analysis_operator(w, name)[:L_w] if x else None))
        syn.append((
            wavelets.synthesis_operator(L_h, name)[:h] if y else None,
            wavelets.synthesis_operator(L_w, name)[:w, :L_w] if x else None))
    return {
        "an_y": tuple(p[0] for p in an),
        "an_x_lo": tuple(p[1] for p in an),
        "syn_y": tuple(p[0] for p in syn[::-1]),
        "syn_x_lo": tuple(p[1] for p in syn[::-1]),
    }


_NOTCH_RECORDS = (fft_notch.NotchFactors, fft_notch.NotchChirp)


def _upload(consts: dict, device: torch.device) -> dict:
    """Put :func:`_build_constants`' arrays on ``device`` as float32 (int32
    band starts) tensors; None stays None, tensors already there pass
    through, and a level's notch record (:class:`.fft_notch.NotchFactors`,
    :class:`.fft_notch.NotchChirp`) keeps its host ints."""
    with timed("plan.upload"):
        def put(a):
            if a is None:
                return None
            if isinstance(a, _NOTCH_RECORDS):
                return a._replace(**{f: put(v) for f, v in a._asdict().items()
                                     if isinstance(v, np.ndarray)})
            if isinstance(a, torch.Tensor):
                return a.to(device)
            dtype = torch.int32 if a.dtype.kind in "iu" else torch.float32
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        out, tensors = {}, []
        for k, v in consts.items():
            if isinstance(v, dict):  # a banded level's band forms
                out[k] = {name: put(a) for name, a in v.items()}
                tensors += out[k].values()
            else:
                out[k] = tuple(put(a) for a in v)
                tensors += (t for a in out[k] for t in (
                    a if isinstance(a, _NOTCH_RECORDS) else (a,))
                    if isinstance(t, torch.Tensor))
        if device.type == "cuda":
            add("plan.device_bytes",
                sum(t.numel() * t.element_size() for t in tensors))
        return out


@lru_cache(maxsize=32)
def build_plan(
    height: int,
    width: int,
    cells: FilterConfig,
    no_cells: FilterConfig,
) -> DestripePlan:
    if (cells.wavelet, cells.level) != (no_cells.wavelet, no_cells.level):
        raise NotImplementedError(
            "cells/no_cells configs must share wavelet and level "
            "(they do in the reference pipeline); for disjoint configs run "
            "two plans and select on host."
        )
    with timed("plan.build"):  # a cache miss: hits never enter the body
        wav = wavelet(cells.wavelet)
        n_levels, ladder = wavedec2_shapes((height, width), wav,
                                           cells.level)
        return DestripePlan(
            height=height,
            width=width,
            wavelet=cells.wavelet,
            n_levels=n_levels,
            ladder=tuple(ladder),
            cells=cells,
            no_cells=no_cells,
        )


# ---------------------------------------------------------------------------
# Classifier (reference filtering.py:54-88, 459-467)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _classifier_cut(
    center: float, crossover: float, threshold_mask: float
) -> Optional[float]:
    """Exact single-compare form of the float16 sigmoid classifier: over the
    float16 lattice ``sigmoid((x - center) / crossover) > threshold_mask``
    equals ``x16 >= cut`` for one breakpoint, found by evaluating the numpy
    float16 chain on all 65536 bit patterns. None if it is not monotone."""
    bits = np.arange(65536, dtype=np.uint16)
    v = bits.view(np.float16)
    v = v[np.isfinite(v) | np.isinf(v)]
    with np.errstate(over="ignore", invalid="ignore"):
        z = (v - np.float16(center)) / np.float16(crossover)
        frac = np.float16(1) / (np.float16(1) + np.exp(-z))
    m = frac > np.float16(threshold_mask)
    order = np.argsort(v.astype(np.float64), kind="stable")
    vs, ms = v[order], m[order]
    if not ms.any():
        return None
    first = int(np.argmax(ms))
    if not bool(np.all(ms[first:])) or bool(np.any(ms[:first])):
        return None
    return float(vs[first])


@lru_cache(maxsize=8)
def _classifier_cut_f32(
    center: float, crossover: float, threshold_mask: float
) -> Optional[float]:
    """Smallest float32 ``b`` with ``float16(b) >= cut``: ``f16(x) >= cut``
    iff ``x >= b`` for every float32 or integer x, so a kernel evaluates the
    float16 classifier as one f32 compare."""
    cut = _classifier_cut(center, crossover, threshold_mask)
    if cut is None or not cut > 0:
        return None
    c16 = np.float16(cut)
    lo_b = np.float32(np.nextafter(c16, -np.inf, dtype=np.float16)).view(
        np.uint32)
    hi_b = np.float32(c16).view(np.uint32)
    while hi_b - lo_b > 1:
        mid_b = np.uint32((int(lo_b) + int(hi_b)) // 2)
        if np.float16(mid_b.view(np.float32)) >= c16:
            hi_b = mid_b
        else:
            lo_b = mid_b
    return float(np.uint32(hi_b).view(np.float32))


def classify_from_sums(fg_cnt, bg_cnt, fg_sum, bg_sum,
                       microscope_high_int: float) -> torch.Tensor:
    """Per-plane cells decision from the four (B,) float32 reductions."""
    fg_mean = torch.where(fg_cnt > 0, fg_sum / fg_cnt.clamp_min(1.0), 0.0)
    bg_mean = torch.where(bg_cnt > 0, bg_sum / bg_cnt.clamp_min(1.0), 0.0)
    return (fg_mean > bg_mean) & (fg_mean > microscope_high_int)


def classify_planes(images: torch.Tensor, microscope_high_int: float,
                    threshold_mask: float = 0.3) -> torch.Tensor:
    """Per-plane bool: does the plane contain cells? The float16 sigmoid
    foreground classifier and the fore/back mean comparison; the sums run
    in float64 (exact for uint16 planes) and round once to float32, as the
    K1 side channel does."""
    sums = classifier_sums(images, threshold_mask)
    return classify_from_sums(
        *(s.to(torch.float32) for s in sums), microscope_high_int)


def classifier_sums(images: torch.Tensor, threshold_mask: float = 0.3):
    """The classifier's four per-plane float64 sums ``(fg_cnt, bg_cnt,
    fg_sum, bg_sum)``, each (B,): exact for uint16 planes, so the sums of
    row shards add up to the plane's."""
    x16 = images.to(torch.float16)
    cut = _classifier_cut(400.0, 20.0, float(threshold_mask))
    if cut is not None:
        cell = x16 >= cut
    else:  # pragma: no cover - production parameters are monotone
        z = (x16 - 400.0) / 20.0
        cell = 1 / (1 + torch.exp(-z)) > threshold_mask
    xd = images.to(torch.float64)
    dims = tuple(range(1, images.ndim))
    return (
        cell.sum(dims, dtype=torch.float64),
        (~cell).sum(dims, dtype=torch.float64),
        torch.where(cell, xd, 0.0).sum(dims),
        torch.where(cell, 0.0, xd).sum(dims),
    )


def _row_median(x: torch.Tensor) -> torch.Tensor:
    """Exact median over the last axis, keepdims. Float32 runs
    :func:`.cuda_notch.row_median_batch`: the Hopper radix-select kernel
    for a CUDA tensor, its plain twin for a CPU one. Another dtype sorts
    (:func:`.cuda_notch.row_median`), as the JAX package does there; both
    are exact and average the two middle values of even rows."""
    if x.dtype == torch.float32:
        return cuda_notch.row_median_batch(x)
    return cuda_notch.row_median(x)


# ---------------------------------------------------------------------------
# Per-level horizontal-band filtering (reference filtering.py:186-219)
# ---------------------------------------------------------------------------


def _filter_level_delta(
    ch: torch.Tensor,  # (B, h, w) horizontal-detail band
    is_cells: torch.Tensor,  # (B,) bool
    bmat_cat,  # (w, 2w) [cells | no_cells] notch operators, or a record
    thr_cells: float,
    thr_no_cells: float,
    abs_range=None,  # optional per-plane (min|ch|, max|ch|) for Otsu
    otsu_sqrt=None,  # optional per-output-plane sqrt(otsu(ch**2))
    notch_apply=None,  # (kB, h, w) -> (kB, h, 2w) where bmat_cat is None
    level: int = 0,  # the band's level, for the spans' names
) -> torch.Tensor:
    """Per-level synthesis delta ``filter(ch) - ch``: the Otsu stripe
    threshold (capped by the configuration's), then
    :func:`.cuda_notch.notch_delta` (mask -> row-median inpaint -> notch ->
    recombine), or :func:`.cuda_notch.notch_delta_lowrank` where
    ``bmat_cat`` is the level's :class:`.fft_notch.NotchFactors`, or
    :func:`.cuda_notch.notch_delta_fft` where it is its
    :class:`.fft_notch.NotchChirp`.
    ``is_cells`` (and ``otsu_sqrt``) may hold k x B entries for B band
    planes: k deltas per plane (dual band, k = 2).
    A width-gated level (``bmat_cat`` None) applies both
    notches with ``notch_apply`` (the rfft form) in the dense formulation,
    as the JAX package does."""
    # scalars, not tensors made from them: a tensor made on the card from a
    # host value is a blocking copy, and the step must not wait on the host
    max_thr = torch.where(is_cells, float(thr_cells), float(thr_no_cells))
    if otsu_sqrt is None:
        with span(_SPAN_OTSU[level]):
            otsu_sqrt = threshold_otsu_batch(ch, square=True,
                                             abs_range=abs_range, sqrt=True)
    with span(_SPAN_NOTCH[level]):
        threshold = torch.minimum(max_thr, otsu_sqrt)
        sel = torch.where(is_cells, 0, 1).to(torch.int32)
        if isinstance(bmat_cat, fft_notch.NotchFactors):
            return cuda_notch.notch_delta_lowrank(ch, threshold, sel,
                                                  *bmat_cat)
        if isinstance(bmat_cat, fft_notch.NotchChirp):
            return cuda_notch.notch_delta_fft(ch, threshold, sel, bmat_cat)
        if bmat_cat is None:
            return cuda_notch.notch_delta_plain(ch, threshold, sel, None,
                                                notch_apply)
        return cuda_notch.notch_delta(ch, threshold, sel, bmat_cat)


def normalize_flat_dark(height: int, width: int, flat, dark, device):
    """Validate a (flat, dark) pair and bring it to the plane extent as
    contiguous float32 tensors on ``device``: paired-or-absent check,
    darkfield crop, broadcast of 2-D fields to (H, W)."""
    if (flat is None) != (dark is None):
        raise ValueError(
            "flat and dark must be provided together "
            "(pass dark=torch.zeros((1, 1)) for a zero darkfield)"
        )
    if flat is None:
        return None, None
    hw = (height, width)
    flat = torch.as_tensor(flat, dtype=torch.float32, device=device)
    dark = torch.as_tensor(dark, dtype=torch.float32, device=device)
    if dark.ndim >= 2:
        dark = dark[..., :height, :width]
    if flat.ndim <= 2 and dark.ndim <= 2:
        try:
            flat = torch.broadcast_to(flat, hw)
            dark = torch.broadcast_to(dark, hw)
        except RuntimeError:
            raise ValueError(
                f"flat {tuple(flat.shape)} / dark {tuple(dark.shape)} do "
                f"not broadcast to the plane extent {hw}"
            ) from None
    return flat.contiguous(), dark.contiguous()


# ---------------------------------------------------------------------------
# The full batched step
# ---------------------------------------------------------------------------


def destripe_batch(
    plan: DestripePlan,
    images: torch.Tensor,  # (B, H, W) uint16 or float32
    microscope_high_int: float = 2700.0,
    consts: Optional[dict] = None,
    flat=None,
    dark=None,
    wrap: bool = False,
    dual: bool = False,
) -> torch.Tensor:
    """log-space wavelet-FFT destripe of a batch of planes on the device of
    ``images``; returns float32 of the same shape, or uint16 through the
    flat-field correction (``flat``/``dark``) or the zarr-store wrap cast
    (``wrap=True``). ``consts``: the plan's constants on that device
    (:func:`device_constants`, built when None).

    ``dual=True`` skips the classifier and filters every plane with both
    configurations: it returns (2B, H, W) float32, ``[:B]`` with
    ``plan.cells`` (the foreground band) and ``[B:]`` with
    ``plan.no_cells`` (the background band); blend them before any
    epilogue."""
    if flat is not None and wrap:
        raise ValueError("flat-field and wrap epilogues are exclusive")
    if dual and (flat is not None or wrap):
        raise ValueError(
            "dual mode returns both float32 bands; blend them before "
            "applying a flat-field or wrap epilogue"
        )
    device = images.device
    if images.dtype not in (torch.uint16, torch.float32):
        images = images.to(torch.float32)  # the kernels read uint16 or f32
    flat, dark = normalize_flat_dark(plan.height, plan.width, flat, dark,
                                     device)

    def epilogue(y):
        if flat is not None:
            return flatfield_correction(y, flat, dark)
        return wrap_cast(y) if wrap else y

    def xlog():
        return torch.log(1.0 + images.to(torch.float32))

    if plan.n_levels == 0:  # tiny image: wavedec2 returns it untouched
        out = epilogue(torch.exp(xlog()) + 1.0)
        return torch.cat([out, out]) if dual else out
    if consts is None:
        consts = device_constants(plan, device)
    bands = {lvl for lvl in range(plan.n_levels) if f"band{lvl}" in consts}

    # Classifier: when level 0 is banded, K1 emits the four sums while it
    # streams the raw planes, so the classifier costs no extra read. Dual
    # mode has none: the first half of the 2B outputs takes the cells
    # configuration, the second half the no-cells one.
    B = images.shape[0]
    cut32 = (_classifier_cut_f32(400.0, 20.0, 0.3)
             if 0 in bands and not dual else None)
    if dual:
        is_cells = torch.arange(2 * B, device=device) < B
    elif cut32 is None:
        with span("classify"):
            is_cells = classify_planes(images, microscope_high_int)
    else:
        is_cells = None  # K1 emits it at level 0

    # Analysis, finest -> coarsest: the x pass (lowpass half only) first,
    # since it halves the width before the y pass doubles the rows' bands.
    chs, ch_ranges = [], {}
    a = None
    for lvl, (an_y, an_x_lo) in enumerate(zip(consts["an_y"],
                                              consts["an_x_lo"])):
        with span(_SPAN_AN[lvl]):
            if lvl in bands:
                bd = consts[f"band{lvl}"]
                src = images if lvl == 0 else a
                if lvl == 0 and cut32 is not None:
                    lox_w, sums = cuda_band.an_x_lowpass_log1p(
                        src, an_x_lo, bd["k1_start"], bd["k1_coef"],
                        cls_cut=cut32,
                    )
                    is_cells = classify_from_sums(*sums.unbind(1),
                                                  microscope_high_int)
                else:
                    lox_w = cuda_band.an_x_lowpass_log1p(
                        src, an_x_lo, bd["k1_start"], bd["k1_coef"],
                        log1p=(lvl == 0),
                    )
                a, ch, ch_ranges[lvl] = cuda_band.an_y_pass(
                    lox_w, an_y, bd["k2_start"], bd["k2_lo"], bd["k2_hi"])
                del lox_w
                chs.append(ch)
                continue
            if a is None:
                a = xlog()
            lox = cuda_dense.dense_matmul(
                an_y, cuda_dense.dense_matmul(a, an_x_lo.t()))
            L_h = lox.shape[-2] // 2
            a = lox[..., :L_h, :]  # cA: lowpass-y, lowpass-x
            # cH: highpass-y, lowpass-x
            chs.append(lox[..., L_h:, :].contiguous())
    del a

    # Filter each cH band, coarsest first (the notch operators' order).
    # Dual: one Otsu per band plane, shared by both configurations (the
    # stripe threshold depends on the coefficients only), tiled to 2B.
    n = len(chs)
    deltas = []
    for j, bm_cat in enumerate(consts["notch_cat"]):
        ch = chs[n - 1 - j]
        abs_range = ch_ranges.get(n - 1 - j)
        otsu_sqrt = None
        if dual:
            with span(_SPAN_OTSU[n - 1 - j]):
                otsu_sqrt = threshold_otsu_batch(
                    ch, square=True, abs_range=abs_range, sqrt=True,
                    repeat=2)
        deltas.append(_filter_level_delta(
            ch, is_cells, bm_cat,
            plan.cells.max_threshold, plan.no_cells.max_threshold,
            abs_range=abs_range, otsu_sqrt=otsu_sqrt, level=n - 1 - j,
        ))
        chs[n - 1 - j] = None
    del chs

    # Delta synthesis, coarsest -> finest: the unfiltered pyramid
    # reconstructs log(1 + x) exactly, so only the correction
    # [coarser correction; cH delta] goes through the synthesis operators.
    corr = None
    for i, (syn_y, syn_x_lo) in enumerate(zip(consts["syn_y"],
                                              consts["syn_x_lo"])):
        delta, deltas[i] = deltas[i], None
        lvl = n - 1 - i
        with span(_SPAN_SYN[lvl]):
            if lvl in bands:
                bd = consts[f"band{lvl}"]
                stacked = cuda_band.syn_y_pass(
                    corr, delta, syn_y, bd["k3_start"], bd["k3_lo"],
                    bd["k3_hi"])
                if lvl > 0:
                    corr = cuda_band.syn_x_exp(
                        stacked, None, syn_x_lo, bd["k4_start"],
                        bd["k4_coef"])
                    continue
                # finest level: exp and the uint16 epilogue fused into K4 (in
                # dual mode K4 reads raw plane b mod B for correction b)
                hw = (plan.height, plan.width)
                if flat is not None and tuple(flat.shape) == hw:
                    return cuda_band.syn_x_exp(
                        stacked, images, syn_x_lo, bd["k4_start"],
                        bd["k4_coef"], flat=flat, dark=dark)
                out = cuda_band.syn_x_exp(
                    stacked, images, syn_x_lo, bd["k4_start"],
                    bd["k4_coef"], wrap=wrap)
                if wrap:
                    return out
                with span("epilogue"):
                    return epilogue(out)
            L_h = syn_y.shape[-1] // 2
            if corr is None:
                stacked = cuda_dense.dense_matmul(syn_y[:, L_h:], delta)
            else:
                up = torch.cat([corr[..., :L_h, :], delta], dim=-2)
                stacked = cuda_dense.dense_matmul(syn_y, up)
            corr = cuda_dense.dense_matmul(stacked, syn_x_lo.t())

    with span("epilogue"):
        xl = xlog()
        if dual:  # both bands' corrections apply to the same log-space input
            xl = torch.cat([xl, xl])
        return epilogue(torch.exp(xl + corr) + 1.0)


# ---------------------------------------------------------------------------
# Single-config entry point (reference filtering.py:139-224)
# ---------------------------------------------------------------------------


def log_space_fft_filtering(
    input_image,
    wavelet: str = "db3",
    level: Optional[int] = 0,
    sigma: float = 64,
    max_threshold: float = 4,
    device=None,
):
    """Host convenience entry point: a 2-D plane or a (B, H, W) batch of
    planes (numpy) in, float32 numpy out, filtered per plane with one
    configuration. ``device``: where to run (None: the current CUDA device;
    raises when there is none)."""
    from ..parallel.mesh import one_device

    img = np.asarray(input_image)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    dev = one_device(device)
    f32_matmul()
    cfg = FilterConfig(wavelet=wavelet, level=level, sigma=float(sigma),
                       max_threshold=float(max_threshold))
    plan = build_plan(img.shape[-2], img.shape[-1], cfg, cfg)
    x = torch.as_tensor(img.astype(np.float32), device=dev)
    with torch.inference_mode():
        out = destripe_batch(plan, x, -np.inf).cpu().numpy()
    return out[0] if squeeze else out
