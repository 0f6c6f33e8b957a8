"""
The per-level notch tail of the destripe step and exact row medians: the
wrappers of the Hopper kernels in ``csrc/notch.cu`` and their plain PyTorch
twins.

Counterpart of ``aind_smartspim_destripe_tpu/ops/pallas_notch.py``
(``notch_delta``, ``notch_select_chunked``) and ``ops/pallas_median.py``
(``row_median_batch``, ``row_median_masked``).
Each wrapper dispatches on the device of its input: a CPU tensor takes the
plain twin (also callable directly as ``<wrapper>_plain`` on any device), a
CUDA tensor launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

- :func:`row_median_batch`: the exact median over the last axis of an
  f32 array of any rank;
- :func:`row_median_masked`: the median of each row of
  ``where(sqrt(x*x) > thr[b], 0, x)``;
- :func:`notch_delta`: stripe mask -> row-median inpaint -> the plane's
  notch operator -> the synthesis delta ``filtered - ch``;
- :func:`notch_delta_lowrank`: the same delta from the notch's exact-rank
  factors (``fft_notch.notch_factors``): a projection onto the frequencies
  whose gain is not 1.0, then their synthesis;
- :func:`notch_delta_fft`: the same delta by chirp-z transforms
  (``fft_notch.notch_chirp``): the spectrum at the frequencies whose gain
  is not 1.0, scaled by the gains minus 1 and synthesised back;
- :func:`notch_select`: the product ``x[b] @ op[sel[b]]`` alone, for the
  row-sharded route, with the operator bank of
  :func:`stacked_notch_operators`.

Both take per-plane ``thr`` (and ``sel``) of k x B entries for a band of B
planes: output plane ``b`` reads band plane ``b mod B`` with its own
threshold and operator (the dual-band form, k = 2), without a concatenated
copy of the band.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import fft_notch
from .cuda_build import check, launch, on_cuda
from .cuda_dense import _GRID_MAX, copy_width

__all__ = [
    "row_median",
    "median_route",
    "masked_median_route",
    "row_median_batch",
    "row_median_masked",
    "notch_delta",
    "notch_delta_lowrank",
    "notch_delta_fft",
    "notch_select",
    "stacked_notch_operators",
    "plan_notch_select",
    "plan_notch_delta",
    "plan_notch_lowrank",
    "row_median_batch_plain",
    "row_median_masked_plain",
    "notch_delta_plain",
    "notch_delta_lowrank_plain",
    "notch_delta_fft_plain",
    "notch_select_plain",
    "KERNELS",
]

_SHORT_THREADS = 256  # rows per block of the short route
# The medians' routes (csrc/notch.cu): the unmasked median's rows of up to
# _SHORT_MAX values take a thread each (keys in registers), the masked
# median's rows of up to _WARP_MAX a warp each (at most 32 keys per lane in
# registers, _WARP_ROWS warps per block); longer rows a block each with their
# keys staged in shared memory up to _STAGE_CAP, read from device memory at
# every pass above it.
SHORT, STAGED, L2, WARP = 0, 1, 2, 3
_SHORT_MAX = 32
_WARP_MAX = 1024
_WARP_ROWS = 4
_STAGE_CAP = 11264
_INT_MAX = 2**31 - 1
_SELECT_TILE = 128  # notch_select's output tile edge (csrc/notch.cu)
_NOTCH_TILE_ROWS = 64  # the notch tail's tile: 64 x 128 (csrc/notch.cu)


# ---------------------------------------------------------------------------
# Row medians
# ---------------------------------------------------------------------------


def row_median(x):
    """Exact median over the last axis, keepdims, by sorting (the plain
    twins' median); even lengths average the k-th and (k+1)-th values."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    if n % 2:
        return s[..., n // 2 : n // 2 + 1]
    return (s[..., n // 2 - 1 : n // 2] + s[..., n // 2 : n // 2 + 1]) * 0.5


# the plain twin of row_median_batch, callable on any device
row_median_batch_plain = row_median


def _median_threads(n: int) -> int:
    """Threads of a block that selects in one row of n values: 64 up to
    2048 values (more rows per SM, fewer threads waiting at each pass's
    barriers), 256 above."""
    return 64 if n <= 2048 else 256


def median_route(shape, strides):
    """How ``row_median_batch`` reads an f32 ``(..., n)`` tensor of this
    shape and these strides (in elements): ``(route, sr, se)``, the route
    (SHORT, STAGED or L2, by n) and the flattened ``(rows, n)`` view's row
    and element strides; or None where the kernel cannot read it in place
    (leading axes that do not flatten to one stride, or a long row whose
    elements are not adjacent) and the wrapper copies it."""
    n = shape[-1]
    route = SHORT if n <= _SHORT_MAX else STAGED if n <= _STAGE_CAP else L2
    se = strides[-1] if n > 1 else 1
    lead = [(d, st) for d, st in zip(shape[:-1], strides[:-1]) if d != 1]
    if any(s0 != s1 * d1 for (_, s0), (d1, s1) in zip(lead, lead[1:])):
        return None
    if route != SHORT and se != 1:
        return None
    return route, (lead[-1][1] if lead else n), se


def row_median_batch(x: torch.Tensor) -> torch.Tensor:
    """Exact median over the last axis of f32 ``(..., n)`` -> ``(..., 1)``:
    1-D, 2-D and N-D inputs run as a flattened ``(rows, n)`` view, read in
    place where :func:`median_route` allows (any strides for rows of up to
    32 values: BaSiC's stack with its axis moved last), else from a
    contiguous copy (counted in ``row_median_batch.copies``). Even ``n``
    averages the k-th and (k+1)-th values as ``(v1 + v2) * 0.5``; NaN sorts
    above +inf, and -0.0 and +0.0 are equal values, so a median may carry
    either sign of zero."""
    if not on_cuda(x):
        return row_median_batch_plain(x)
    n = x.shape[-1] if x.ndim else 0
    if n == 0:
        raise ValueError(f"row_median_batch needs n >= 1, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype} not in (torch.float32,)")
    form = median_route(x.shape, x.stride())
    if form is None:
        x = x.contiguous()
        row_median_batch.copies += 1
        form = median_route(x.shape, x.stride())
    route, sr, se = form
    dev = x.device
    rows = x.numel() // n
    med = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    if rows:
        launch("destripe_row_median_batch", dev, x.data_ptr(), med.data_ptr(),
               rows, n, sr, se, route,
               _SHORT_THREADS if route == SHORT else _median_threads(n))
        row_median_batch.launches += 1
    return med


def _n_out(x, thr) -> int:
    """The output batch: thr's length, a multiple of x's batch."""
    n_out, B = thr.shape[0], x.shape[0]
    if B == 0 or n_out % B:
        raise ValueError(f"output batch {n_out} not a multiple of input {B}")
    return n_out


def _tiled(x, n_out):
    """The band tiled to the output batch (plane b is band plane b mod B);
    the plain twins' counterpart of the kernels' wrapped index."""
    return x if n_out == x.shape[0] else x.repeat(n_out // x.shape[0], 1, 1)


def _stripe_mask(x, thr):
    # sqrt(x*x), not |x|: the reference compares the rounded sqrt-of-square,
    # which differs from |x| in ulp/underflow corners
    return (torch.sqrt(x * x) > thr[:, None, None]).to(x.dtype)


def row_median_masked_plain(x, thr):
    """Plain twin of :func:`row_median_masked`, on any device."""
    x = _tiled(x, _n_out(x, thr))
    return row_median(x * (1.0 - _stripe_mask(x, thr)))


def masked_median_route(w: int):
    """``(route, param)`` of ``row_median_masked``'s launch for rows of w
    values: WARP (a warp per output row, ``param`` keys per lane, the least
    power of two that holds the row) up to 1024 values; above, STAGED up to
    11264 values and L2 beyond (a block of ``param`` threads per output
    row, as :func:`_median_threads` gives it). Raises ValueError for
    w < 1."""
    if w < 1:
        raise ValueError(f"row_median_masked needs rows of w >= 1, got {w}")
    if w <= _WARP_MAX:
        return WARP, 1 << (-(-w // 32) - 1).bit_length()
    return (STAGED if w <= _STAGE_CAP else L2), _median_threads(w)


def _check_masked_grid(route, n_out, h):
    """Raise ValueError where a route's grid cannot hold the rows: WARP puts
    the n_out * h output rows on grid.x (_WARP_ROWS per block), the block
    routes h rows on grid.x and n_out planes on grid.y (at most 65535)."""
    if (h > _INT_MAX or n_out > _INT_MAX
            or (route == WARP and -(-n_out * h // _WARP_ROWS) > _INT_MAX)
            or (route != WARP and n_out > _GRID_MAX)):
        raise ValueError(f"{n_out} output planes of {h} rows exceed the "
                         f"kernel's grid")


def row_median_masked(
    x: torch.Tensor,  # (B, h, w) float32
    thr: torch.Tensor,  # (kB,) float32 per-output-plane stripe threshold
) -> torch.Tensor:
    """Per-row median (kB, h, 1) of ``where(sqrt(x*x) > thr[b], 0, x)``
    over band plane ``b mod B``: the inpainting background median, with the
    mask applied as the row is read. On the card the route follows the row
    length (:func:`masked_median_route`); the warp route puts a band row's
    k outputs on neighbouring warps, so the row comes from device memory
    once."""
    if not on_cuda(x):
        return row_median_masked_plain(x, thr)
    B, h, w = x.shape
    n_out = _n_out(x, thr)
    dev = x.device
    check("x", x, (torch.float32,), dev)
    check("thr", thr, (torch.float32,), dev, (n_out,))
    route, param = masked_median_route(w)
    _check_masked_grid(route, n_out, h)
    med = torch.empty((n_out, h, 1), dtype=torch.float32, device=dev)
    if med.numel():
        launch("destripe_row_median", dev, x.data_ptr(), thr.data_ptr(),
               med.data_ptr(), n_out, B, h, w, route, param)
        row_median_masked.launches += 1
    return med


# ---------------------------------------------------------------------------
# The notch tail
# ---------------------------------------------------------------------------


def notch_delta_plain(ch, thr, sel, notch_cat, notch_apply=None):
    """Plain twin of :func:`notch_delta`, on any device: the JAX package's
    dense formulation (both notch products in one matrix product, selected
    per plane afterwards). With ``notch_cat`` None, ``notch_apply`` maps the
    inpainted band (kB, h, w) to both filtered bands (kB, h, 2w) instead
    (the rfft notch of a width-gated level)."""
    w = ch.shape[-1]
    ch = _tiled(ch, _n_out(ch, thr))
    mask = _stripe_mask(ch, thr)
    foreground = ch * mask
    background = ch * (1.0 - mask)
    inpainted = background + row_median(background) * mask
    del background
    both = (notch_apply(inpainted) if notch_cat is None
            else torch.matmul(inpainted, notch_cat))
    del inpainted
    filtered = torch.where((sel == 0)[:, None, None], both[..., :w],
                           both[..., w:])
    del both
    return foreground + filtered * (1.0 - mask) - ch


def notch_delta(
    ch: torch.Tensor,  # (B, h, w) float32 horizontal-detail band
    thr: torch.Tensor,  # (kB,) float32 per-output-plane stripe threshold
    sel: torch.Tensor,  # (kB,) int32: 0 = cells operator, 1 = no-cells
    notch_cat: torch.Tensor,  # (w, 2w) float32 [cells | no-cells] operators
) -> torch.Tensor:
    """The per-level synthesis delta (kB, h, w) float32: output plane b
    reads band plane ``c = ch[b mod B]``; with ``stripes = sqrt(c*c) >
    thr[b]`` and ``med`` the row median of the unstriped values (stripes
    read as 0), ``where(stripes, 0, where(stripes, med, c) @ notch_cat[:,
    sel[b]*w : (sel[b]+1)*w] - c)``.

    On the card this is two launches: :func:`row_median_masked`, then the
    shared GEMM tile (``csrc/gemm_f32.cuh``) with the mask and inpainting
    applied to the band as it is loaded and the delta in its epilogue,
    multiplying each plane by its own operator only; each output is summed
    in k order, one FMA per term from 0."""
    if not on_cuda(ch):
        return notch_delta_plain(ch, thr, sel, notch_cat)

    B, h, w = ch.shape
    n_out = _n_out(ch, thr)
    dev = ch.device
    check("ch", ch, (torch.float32,), dev)
    check("thr", thr, (torch.float32,), dev, (n_out,))
    check("sel", sel, (torch.int32,), dev, (n_out,))
    check("notch_cat", notch_cat, (torch.float32,), dev, (w, 2 * w))
    v = plan_notch_delta(n_out, h, w, ch.data_ptr() % 8,
                         notch_cat.data_ptr() % 8)
    med = row_median_masked(ch, thr)
    out = torch.empty((n_out, h, w), dtype=torch.float32, device=dev)
    launch("destripe_notch", dev, ch.data_ptr(), med.data_ptr(),
           thr.data_ptr(), sel.data_ptr(), notch_cat.data_ptr(),
           out.data_ptr(), n_out, B, h, w, v)
    notch_delta.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def plan_notch_delta(n_out: int, h: int, w: int, x_ptr: int = 0,
                     bank_ptr: int = 0):
    """The floats per load ``v`` of the notch tail's launch for n_out
    planes of (h, w) at these addresses (bytes; only their alignment is
    read), by the shared GEMM tile's rule (:func:`.cuda_dense.copy_width`,
    as for :func:`plan_notch_select`; cached: the step calls it with a few
    forms). Raises ValueError where the kernel's grid (64-row tiles) would
    overflow."""
    if n_out > _GRID_MAX or -(-h // _NOTCH_TILE_ROWS) > _GRID_MAX:
        raise ValueError(f"{n_out} planes of {h} rows exceed the kernel's "
                         f"grid")
    return min(copy_width(x_ptr, 1, (w, h * w)),
               copy_width(bank_ptr, 1, (2 * w, w)))


def _check_ranks(ranks, rp):
    if len(ranks) != 2 or not all(1 <= r <= rp for r in ranks):
        raise ValueError(f"ranks {tuple(ranks)} not two ranks in [1, {rp}]")


def notch_delta_lowrank_plain(ch, thr, sel, p, ds, ranks):
    """Plain twin of :func:`notch_delta_lowrank`, on any device: two
    ``torch.matmul``s and the mask. It sums over all ``rp`` factor terms:
    ``ds``'s rows past a configuration's rank are zero."""
    _check_ranks(ranks, p.shape[-1])
    ch = _tiled(ch, _n_out(ch, thr))
    stripes = torch.sqrt(ch * ch) > thr[:, None, None]
    background = torch.where(stripes, 0.0, ch)
    inpainted = torch.where(stripes, row_median(background), ch)
    del background
    y = torch.matmul(inpainted, p)
    del inpainted
    rp, w = p.shape[-1], ch.shape[-1]
    delta = torch.matmul(y, ds.view(-1, rp, w)[sel.long()])
    return torch.where(stripes, 0.0, delta)


def notch_delta_lowrank(
    ch: torch.Tensor,  # (B, h, w) float32 horizontal-detail band
    thr: torch.Tensor,  # (kB,) float32 per-output-plane stripe threshold
    sel: torch.Tensor,  # (kB,) int32: 0 = cells operator, 1 = no-cells
    p: torch.Tensor,  # (w, rp) float32 packed analysis rows
    ds: torch.Tensor,  # (2 rp, w) float32 [cells; no-cells] synthesis rows
    ranks,  # (cells, no-cells) ranks, host ints in [1, rp]
) -> torch.Tensor:
    """The notch tail of :func:`notch_delta`, (kB, h, w) float32, from the
    factors of each notch operator minus the identity
    (:func:`.fft_notch.notch_factors`): with ``c = ch[b mod B]``,
    ``stripes`` and the row median ``med`` as there, ``r = ranks[sel[b]]``
    and ``d = ds[sel[b] rp:]``, ``where(stripes, 0, where(stripes, med, c)
    @ p[:, :r] @ d[:r])``. Where ``c`` is not a stripe the inpainted value
    is ``c``, so ``inpainted @ op - c`` there is ``inpainted @ (op - I)``:
    the same delta, with the terms whose gain is exactly 1.0 left out.

    On the card this is three launches: :func:`row_median_masked`, the
    projection ``y = inpaint(c) @ p[:, :r]`` (h x r, the mask and the
    inpainting applied as the band is loaded, as in :func:`notch_delta`)
    and the synthesis ``stripes ? 0 : y @ d[:r]``, both on the shared GEMM
    tile (``csrc/gemm_f32.cuh``), each plane to its own rank; each output
    is summed in k order, one FMA per term from 0."""
    if not on_cuda(ch):
        return notch_delta_lowrank_plain(ch, thr, sel, p, ds, ranks)

    B, h, w = ch.shape
    n_out = _n_out(ch, thr)
    rp = p.shape[-1]
    dev = ch.device
    check("ch", ch, (torch.float32,), dev)
    check("thr", thr, (torch.float32,), dev, (n_out,))
    check("sel", sel, (torch.int32,), dev, (n_out,))
    check("p", p, (torch.float32,), dev, (w, rp))
    check("ds", ds, (torch.float32,), dev, (2 * rp, w))
    _check_ranks(ranks, rp)
    vp, vs = plan_notch_lowrank(n_out, h, w, rp, ch.data_ptr() % 8,
                                p.data_ptr() % 8, ds.data_ptr() % 8)
    med = row_median_masked(ch, thr)
    y = torch.empty((n_out, h, rp), dtype=torch.float32, device=dev)
    launch("destripe_notch_project", dev, ch.data_ptr(), med.data_ptr(),
           thr.data_ptr(), sel.data_ptr(), p.data_ptr(), y.data_ptr(),
           n_out, B, h, w, rp, *ranks, vp)
    del med
    out = torch.empty((n_out, h, w), dtype=torch.float32, device=dev)
    launch("destripe_notch_synth", dev, ch.data_ptr(), thr.data_ptr(),
           sel.data_ptr(), y.data_ptr(), ds.data_ptr(), out.data_ptr(),
           n_out, B, h, w, rp, *ranks, vs)
    notch_delta_lowrank.launches += 2
    return out


@functools.lru_cache(maxsize=256)
def plan_notch_lowrank(n_out: int, h: int, w: int, rp: int, x_ptr: int = 0,
                       p_ptr: int = 0, ds_ptr: int = 0):
    """The floats per load ``(v_project, v_synth)`` of the low-rank notch
    tail's two launches for n_out planes of (h, w) and factors of rp
    columns at these addresses (bytes; only their alignment is read), by
    the shared GEMM tile's rule (:func:`.cuda_dense.copy_width`): the
    projection reads the band's rows and p's, the synthesis ds's (y's rows
    are even and aligned). Raises ValueError where a grid (64-row tiles)
    would overflow or rp is odd."""
    if n_out > _GRID_MAX or -(-h // _NOTCH_TILE_ROWS) > _GRID_MAX:
        raise ValueError(f"{n_out} planes of {h} rows exceed the kernel's "
                         f"grid")
    if rp % 2:
        raise ValueError(f"the factors' width {rp} must be even")
    return (min(copy_width(x_ptr, 1, (w, h * w)), copy_width(p_ptr, 1, (rp,))),
            copy_width(ds_ptr, 1, (w, rp * w)))


def _fft_pairs(x, k_out):
    """The (n_out, h, w) rows as the pairs the chirp-z kernel puts in one
    complex sequence: ``(first, second)``, each (P, h', w). k_out 1: rows
    2p and 2p + 1 of each plane (an odd last row paired with zeros); k_out
    2: the two outputs of each band row."""
    if k_out == 2:
        return x.chunk(2)
    if x.shape[1] % 2:
        x = torch.cat([x, x.new_zeros(x.shape[:1] + (1,) + x.shape[2:])], 1)
    return x[:, 0::2], x[:, 1::2]


def _complex(t):
    """A (..., 2) float tensor of (re, im) pairs as complex128."""
    t = t.double()
    return torch.complex(t[..., 0], t[..., 1])


def notch_delta_fft_plain(ch, thr, sel, rec):
    """Plain twin of :func:`notch_delta_fft`, on any device: the kernel's
    chirp-z arithmetic on the same pairs of rows, in float64 from the
    float32 tables of ``rec`` (:class:`.fft_notch.NotchChirp`), with
    ``torch.fft`` for the M-point FFTs."""
    B, h, w = ch.shape
    n_out = _n_out(ch, thr)
    k_out = n_out // B
    if k_out not in (1, 2):
        raise ValueError(f"{k_out} outputs per band plane: the chirp-z tail "
                         f"takes 1 or 2")
    c = _tiled(ch, n_out)
    stripes = torch.sqrt(c * c) > thr[:, None, None]
    inp = torch.where(stripes, row_median(torch.where(stripes, 0.0, c)), c)
    chirp, filt = _complex(rec.chirp), _complex(rec.filters)
    gains = rec.gains.double()[sel.long()][:, None]  # (n_out, 1, K + 1, 2)
    gains = gains.expand(n_out, h, *gains.shape[2:])
    m, k = filt.shape[-1], rec.k
    x1, x2 = _fft_pairs(inp.double(), k_out)
    g1, g2 = _fft_pairs(gains, k_out)
    z = torch.complex(x1, x2) * chirp
    conv = torch.fft.ifft(torch.fft.fft(z, n=m) * filt[0], norm="forward")
    ks = torch.arange(-k, k + 1, device=ch.device)
    ka = ks.abs()
    zk = conv[..., ks % m] * chirp[ka]
    zm = zk.flip(-1).conj()  # conj(Z_-k)
    sm, df = zk + zm, zk - zm
    ga, gb = g1[..., ka, :], g2[..., ka, :]
    e = torch.complex(ga[..., 0] * sm.real + gb[..., 1] * df.real,
                      ga[..., 1] * sm.imag + gb[..., 0] * df.imag)
    b = z.new_zeros(z.shape[:-1] + (m,))
    b[..., ks % m] = e * chirp[ka].conj()
    conv = torch.fft.ifft(torch.fft.fft(b) * filt[1], norm="forward")
    y = chirp.conj() * conv[..., :w]
    if k_out == 2:
        out = torch.cat([y.real, y.imag])
    else:
        out = torch.stack([y.real, y.imag], 2).flatten(1, 2)[:, :h]
    return torch.where(stripes, 0.0, out.to(ch.dtype))


def notch_delta_fft(
    ch: torch.Tensor,  # (B, h, w) float32 horizontal-detail band
    thr: torch.Tensor,  # (kB,) float32 per-output-plane stripe threshold
    sel: torch.Tensor,  # (kB,) int32: 0 = cells gains, 1 = no-cells
    rec,  # the level's fft_notch.NotchChirp, its tables on ch's device
) -> torch.Tensor:
    """The notch tail of :func:`notch_delta`, (kB, h, w) float32, k 1 or
    2, by chirp-z transforms (:func:`.fft_notch.notch_chirp`): with ``c =
    ch[b mod B]``, ``stripes`` and the row median ``med`` as there and
    ``g`` the packed gains of configuration ``sel[b]``, ``where(stripes,
    0, irfft((g - 1) . rfft(where(stripes, med, c))))``, the spectrum
    taken at the frequencies ``0..rec.k`` alone (the gain is 1.0 past
    them). That is ``inpainted @ (op - I)``, which equals ``inpainted @ op
    - c`` wherever ``c`` is not a stripe, with no cancellation of the two.

    On the card this is two launches: :func:`row_median_masked`, then one
    block per pair of output rows (rows 2p and 2p + 1 of a plane; the two
    outputs of a band row for k = 2) through four FFTs of ``M`` points
    in shared memory and registers (``csrc/notch.cu`` notch_fft_kernel),
    the mask and inpainting applied as the band is loaded. A pair is
    computed in one fixed order, so a plane's output is the same at any
    batch size."""
    if not on_cuda(ch):
        return notch_delta_fft_plain(ch, thr, sel, rec)

    B, h, w = ch.shape
    n_out = _n_out(ch, thr)
    dev = ch.device
    m = rec.twiddle.shape[0]
    check("ch", ch, (torch.float32,), dev)
    check("thr", thr, (torch.float32,), dev, (n_out,))
    check("sel", sel, (torch.int32,), dev, (n_out,))
    check("chirp", rec.chirp, (torch.float32,), dev, (w, 2))
    check("filters", rec.filters, (torch.float32,), dev, (2, m, 2))
    check("twiddle", rec.twiddle, (torch.float32,), dev, (m, 2))
    check("gains", rec.gains, (torch.float32,), dev, (2, rec.k + 1, 2))
    if n_out not in (B, 2 * B) or B > _GRID_MAX:
        raise ValueError(f"{n_out} outputs of {B} band planes: the chirp-z "
                         f"tail takes 1 or 2 per plane, at most {_GRID_MAX} "
                         f"planes")
    if m not in fft_notch.CHIRP_M or 2 * rec.k >= w or w + 2 * rec.k > m:
        raise ValueError(f"tables of {m} points and frequencies 0..{rec.k} "
                         f"do not fit width {w}")
    med = row_median_masked(ch, thr)
    out = torch.empty((n_out, h, w), dtype=torch.float32, device=dev)
    launch("destripe_notch_fft", dev, ch.data_ptr(), med.data_ptr(),
           thr.data_ptr(), sel.data_ptr(), rec.chirp.data_ptr(),
           rec.filters.data_ptr(), rec.twiddle.data_ptr(),
           rec.gains.data_ptr(), out.data_ptr(), n_out, B, h, w, m, rec.k)
    notch_delta_fft.launches += 1
    return out


# ---------------------------------------------------------------------------
# The per-plane notch product of the row-sharded route
# ---------------------------------------------------------------------------


def stacked_notch_operators(bc: np.ndarray, bn: np.ndarray) -> np.ndarray:
    """The cells / no-cells notch operators (w, w) as one f32 bank (w, 2w)
    oriented for ``x @ op``: ``[bc.T | bn.T]``, the notch tail's
    ``notch_cat`` layout. The JAX package's bank is a lane-padded bf16 hi/lo
    pair (2, wp, wp); the port keeps f32 and no padding."""
    return np.ascontiguousarray(
        np.concatenate([np.asarray(bc).T, np.asarray(bn).T], axis=1),
        dtype=np.float32)


def notch_select_plain(x, sel, bank):
    """Plain twin of :func:`notch_select`, on any device: one
    ``torch.matmul`` per plane with its selected operator."""
    w = x.shape[-1]
    return torch.stack([
        torch.matmul(x[b], bank[:, s * w:(s + 1) * w])
        for b, s in enumerate(sel.tolist())
    ])


def plan_notch_select(B: int, h: int, w: int, x_ptr: int = 0,
                      bank_ptr: int = 0) -> int:
    """Floats per load of the notch_select launch for B planes of (h, w)
    at these addresses (bytes; only their alignment is read), by the shared
    GEMM tile's rule (:func:`.cuda_dense.copy_width`; the bank's rows are
    read from column ``sel * w``, so an odd w gives 4-byte loads). The tile
    is always the 128 x 128 one: K = w runs long on the route. Raises
    ValueError where the kernel's grid would overflow."""
    if B > _GRID_MAX or -(-h // _SELECT_TILE) > _GRID_MAX:
        raise ValueError(f"{B} planes of {h} rows exceed the kernel's grid")
    return min(copy_width(x_ptr, 1, (w, h * w)),
               copy_width(bank_ptr, 1, (2 * w, w)))


def notch_select(
    x: torch.Tensor,  # (B, h, w) float32 inpainted band
    sel: torch.Tensor,  # (B,) int32: 0 = cells operator, 1 = no-cells
    bank: torch.Tensor,  # (w, 2w) float32 [cells | no-cells] operators
) -> torch.Tensor:
    """``out[b] = x[b] @ bank[:, sel[b]*w : (sel[b]+1)*w]`` -> (B, h, w)
    float32: each plane multiplies only its own operator. The TPU kernel
    streams its bank in output-column chunks to fit scoped VMEM; the card's
    kernel (the GEMM tile of ``csrc/gemm_f32.cuh``) reads the operator tile
    by tile from device memory, so it needs no chunking and runs in one
    launch over the full width; each output is summed in k order, one FMA
    per term from 0."""
    if not on_cuda(x):
        return notch_select_plain(x, sel, bank)
    B, h, w = x.shape
    dev = x.device
    check("x", x, (torch.float32,), dev)
    check("sel", sel, (torch.int32,), dev, (B,))
    check("bank", bank, (torch.float32,), dev, (w, 2 * w))
    v = plan_notch_select(B, h, w, x.data_ptr(), bank.data_ptr())
    out = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    launch("destripe_notch_select", dev, x.data_ptr(), sel.data_ptr(),
           bank.data_ptr(), out.data_ptr(), B, h, w, v)
    notch_select.launches += 1
    return out


KERNELS = (row_median_masked, row_median_batch, notch_delta,
           notch_delta_lowrank, notch_delta_fft, notch_select)
for _k in KERNELS:
    _k.launches = 0
row_median_batch.copies = 0
