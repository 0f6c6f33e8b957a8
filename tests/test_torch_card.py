"""The Hopper kernels of the torch package against their plain PyTorch twins
on the card (marker ``cuda``; every test skips without one).

This file imports no JAX, so it runs on a card host without it, from the
root of a checkout (``tests/conftest.py`` imports JAX, hence the flag):

    python -m pytest --noconftest tests/test_torch_card.py -q

Tolerances. f32 outputs: kernel and twin sum the same products in f32 in
another order (the twin's GEMM adds exact zeros besides), so they agree to
a few ulps of the operands: 1e-5 of the largest operand magnitude. uint16
outputs: 1 LSB (a value on a rounding boundary). Classifier sums, histogram
counts and row medians: exact. The dense levels' products: bit-equal to
the same sums taken term by term in k order (the kernel's fixed order), and
within 1e-5 of the operands' scale of ``torch.matmul``. The blend: 1e-5 of the bands' magnitude
(the kernel and its twin round the same operations; expf may differ by an
ulp). The row-sharded step against the plane path: 1 LSB outside a 1e-4
flip budget (the same Otsu and mask decisions on the same coefficients,
summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aind_smartspim_destripe_torch import ops as tops  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_band as cb  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_blend as tbl  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_dense as td  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_hist as th  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import dual_band as tdb  # noqa: E402
from aind_smartspim_destripe_torch.ops import fft_notch  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402

F32_RTOL = 1e-5

pytestmark = pytest.mark.cuda
# the kernels only the row-sharded route launches
HALO = (cb.an_x_lowpass_chunked, cb.syn_x_exp_chunked, tn.notch_select)
# the kernels the plane step does not launch: the row-sharded route's, the
# unmasked median, reached through ops.filter._row_median alone, and the
# histogram over (lo, span) ranges, which the row-sharded Otsu sums over
# shards (the plane step's Otsu bins through histogram256_range), and the
# exact-rank notch, which only planes far wider than the notch's rank take
OFF_PLANE = HALO + (tn.row_median_batch, th.histogram256_batch,
                    tn.notch_delta_lowrank)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf.f32_matmul()
    return torch.device("cuda")


def _close(got, want, scale=None):
    if want.dtype == torch.uint16:
        d = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
        assert d <= 1, f"uint16 outputs differ by {d} LSB"
        return
    if scale is None:
        scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= F32_RTOL * max(1.0, scale), err


def _ops(hw, lvl, device):
    """The band forms of banded analysis level ``lvl`` in the plane step's
    constants on ``device``, with the level's dense operators, which only
    the plain twins read, from the constants off the card."""
    cfg = tf.FilterConfig(wavelet="db3", level=None, sigma=64,
                          max_threshold=3)
    plan = tf.build_plan(*hw, cfg, cfg)
    host = tf.device_constants(plan, "cpu")
    n = plan.n_levels
    return {
        "an_x_lo": host["an_x_lo"][lvl].to(device),
        "an_y": host["an_y"][lvl].to(device),
        "syn_y": host["syn_y"][n - 1 - lvl].to(device),
        "syn_x_lo": host["syn_x_lo"][n - 1 - lvl].to(device),
        **tf.device_constants(plan, device)[f"band{lvl}"],
    }


@pytest.mark.parametrize("hw,level", [((1600, 2000), 0), ((1600, 2000), 1),
                                      ((1001, 777), 0), ((2048, 2048), 1)])
def test_card_band_kernels_match_twins(card, hw, level):
    ops = _ops(hw, level, card)
    g = torch.Generator(device="cpu").manual_seed(level)
    L = ops["an_x_lo"].shape[0]
    Ho, w = ops["syn_y"].shape[0], ops["syn_x_lo"].shape[0]
    Lh = ops["an_y"].shape[0] // 2
    if level == 0:
        x = torch.randint(0, 4000, (2, Ho, w), generator=g).to(torch.uint16)
    else:
        x = torch.randn((2, Ho, w), generator=g) * 2 + 6
    x = x.to(card)
    cut = tf._classifier_cut_f32(400.0, 20.0, 0.3) if level == 0 else None
    k1 = cb.an_x_lowpass_log1p(x, ops["an_x_lo"], ops["k1_start"],
                               ops["k1_coef"], log1p=level == 0, cls_cut=cut)
    t1 = cb.an_x_lowpass_log1p_plain(x, ops["an_x_lo"], level == 0, cut)
    if cut is not None:
        (k1, ks), (t1, ts) = k1, t1
        assert torch.equal(ks, ts)
    _close(k1, t1)
    lo, hi, (mn, mx) = cb.an_y_pass(k1, ops["an_y"], ops["k2_start"],
                                    ops["k2_lo"], ops["k2_hi"])
    lo_t, hi_t, (mn_t, mx_t) = cb.an_y_pass_plain(k1, ops["an_y"])
    for a, b in ((lo, lo_t), (hi, hi_t), (mn, mn_t), (mx, mx_t)):
        _close(a, b)
    corr = (torch.randn((2, Lh, L), generator=g) * 0.01).to(card)
    delta = (torch.randn((2, Lh, L), generator=g) * 0.01).to(card)

    def k3(c):
        return cb.syn_y_pass(c, delta, ops["syn_y"], ops["k3_start"],
                             ops["k3_lo"], ops["k3_hi"])

    for c in (corr, None):
        _close(k3(c), cb.syn_y_pass_plain(c, delta, ops["syn_y"]))
    st = k3(corr)

    def k4(img, **kw):
        return cb.syn_x_exp(st, img, ops["syn_x_lo"], ops["k4_start"],
                            ops["k4_coef"], **kw)

    if level == 1:
        _close(k4(None), cb.syn_x_exp_plain(st, None, ops["syn_x_lo"]))
        return
    flat = (1.0 + 0.2 * torch.rand((Ho, w), generator=g)).to(card)
    dark = torch.full((Ho, w), 3.0, device=card)
    for kw in (dict(flat=flat, dark=dark), dict(wrap=True), {}):
        _close(k4(x, **kw), cb.syn_x_exp_plain(st, x, ops["syn_x_lo"], **kw))


@pytest.mark.parametrize("shape", [(4, 802, 1002), (4, 403, 503),
                                   (3, 11, 12), (2, 37, 203)])
def test_card_tail_kernels_match_twins(card, shape):
    g = torch.Generator(device="cpu").manual_seed(shape[1])
    ch = (torch.randn(shape, generator=g) * 0.3).to(card)
    B, h, w = shape
    a = ch.abs()
    ranges = {
        True: (a.amin(dim=(1, 2)) ** 2,
               a.amax(dim=(1, 2)) ** 2 - a.amin(dim=(1, 2)) ** 2),
        False: (ch.amin(dim=(1, 2)),
                ch.amax(dim=(1, 2)) - ch.amin(dim=(1, 2))),
    }
    for square, (lo, span) in ranges.items():
        assert torch.equal(
            th.histogram256_batch(ch, lo, span, square=square),
            th.histogram256_batch_plain(ch, lo, span, square=square))
    u16 = torch.randint(0, 4000, shape, generator=g).to(torch.uint16).to(card)
    lo16 = torch.zeros(B, device=card)
    span16 = torch.full((B,), 4000.0, device=card)
    assert torch.equal(th.histogram256_batch(u16, lo16, span16),
                       th.histogram256_batch_plain(u16, lo16, span16))
    thr = torch.linspace(0.1, 0.6, B, device=card)
    assert torch.equal(tn.row_median_masked(ch, thr),
                       tn.row_median_masked_plain(ch, thr))
    sel = (torch.arange(B, device=card) % 2).to(torch.int32)
    cat = (torch.randn((w, 2 * w), generator=g) / w**0.5).to(card)
    got = tn.notch_delta(ch, thr, sel, cat)
    _close(got, tn.notch_delta_plain(ch, thr, sel, cat),
           scale=ch.abs().max().item())
    stripes = torch.sqrt(ch * ch) > thr[:, None, None]
    assert bool((got[stripes] == 0).all())


@pytest.mark.parametrize("shape", [(7,), (5, 8), (3, 17, 33), (2, 3, 9, 10),
                                   (4, 1), (4, 2), (2, 10, 1002),
                                   (64, 802, 1002), (128, 128, 12),
                                   (8, 9000, 7)], ids=str)
def test_card_row_median_batch_matches_twin(card, shape):
    """The unmasked median kernel through ``ops.filter._row_median`` against
    its twin (the sort), exactly, with ties, signed zeros and infinities
    in the rows; (128, 128, 12) is BaSiC's darkfield median at working size
    128 over 12 tiles; (8, 9000, 7) puts 72000 rows on the grid, past
    grid.y's 65535."""
    g = torch.Generator(device="cpu").manual_seed(shape[-1])
    x = torch.randn(shape, generator=g) * 100
    x = torch.where(torch.rand(shape, generator=g) < 0.2, x.round(), x)
    flat = x.view(-1)
    flat[::97] = 0.0
    flat[1::97] = -0.0
    flat[2::193] = float("inf")
    flat[3::389] = -float("inf")
    x = x.to(card)
    tops.reset_launches()
    got = tf._row_median(x)
    assert tn.row_median_batch.launches == 1
    want = tn.row_median_batch_plain(x)
    assert got.shape == want.shape == shape[:-1] + (1,)
    # exact, by value (-0.0 == +0.0), NaN (inf + -inf of an even row's
    # middle pair) equal to NaN
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_card_row_median_batch_any_layout(card):
    """A strided view (BaSiC's stack axis moved last) launches the kernel
    on the view in place, and a view whose leading axes do not flatten on a
    contiguous copy; both equal their twin exactly."""
    g = torch.Generator(device="cpu").manual_seed(12)
    x = (torch.randn((12, 64, 64), generator=g) * 100).to(card)
    for view, copies in ((x.movedim(0, -1), 0), (x.permute(2, 1, 0), 1)):
        assert not view.is_contiguous()
        tops.reset_launches()
        tn.row_median_batch.copies = 0
        got = tf._row_median(view)
        assert tn.row_median_batch.launches == 1
        assert tn.row_median_batch.copies == copies
        assert torch.equal(got, tn.row_median_batch_plain(view))


def _median_keys_witness(x):
    """The median over the last axis with the kernel's order: the values
    sorted by their IEEE keys (NaN above +inf, -0.0 below +0.0), the middle
    key(s) read back as floats, an even row's pair averaged as
    ``(v1 + v2) * 0.5`` in f32."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (u & 0x80000000) != 0
    key = torch.where(neg, u ^ 0xFFFFFFFF, u | 0x80000000)
    key = torch.sort(key, dim=-1).values
    n = x.shape[-1]

    def value(k):
        k = k.clone()
        pos = (k & 0x80000000) != 0
        bits = torch.where(pos, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
        return (bits - ((bits >> 31) << 32)).to(torch.int32).view(
            torch.float32)

    v1 = value(key[..., (n - 1) // 2:(n - 1) // 2 + 1])
    if n % 2:
        return v1
    return (v1 + value(key[..., n // 2:n // 2 + 1])) * 0.5


def _median_rows(n, rows, seed):
    """Rows of n values with ties, both signs of zero, infinities and NaN."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((rows, n), generator=g) * 100
    x = torch.where(torch.rand((rows, n), generator=g) < 0.3, x.round() / 50,
                    x)
    flat = x.view(-1)
    flat[::7] = 0.0
    flat[1::11] = -0.0
    flat[2::37] = float("inf")
    flat[3::41] = -float("inf")
    flat[5::53] = float("nan")
    return x


@pytest.mark.parametrize("n", list(range(1, 65)) + [1001, 1002, 2000, 11264,
                                                 11265])
def test_card_row_median_batch_routes_bit_equal(card, n):
    """The unmasked median on its short (n <= 32: a thread per row, keys in
    registers), staged (keys in shared memory, up to 11264) and device-
    memory routes: bit-equal to the key-order sort, on rows with ties,
    +-0.0, +-inf and NaN, contiguous and (short rows) read in place from a
    stack with its axis moved last."""
    x = _median_rows(n, 300, n).to(card)
    want = _median_keys_witness(x)
    route = tn.median_route(x.shape, x.stride())[0]
    assert route == (tn.SHORT if n <= 32 else
                     tn.STAGED if n <= 11264 else tn.L2)
    tops.reset_launches()
    got = tn.row_median_batch(x)
    assert tn.row_median_batch.launches == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.testing.assert_close(got, tn.row_median_batch_plain(x), rtol=0,
                               atol=0, equal_nan=True)
    stack = x.t().contiguous().view(n, 20, 15)
    tn.row_median_batch.copies = 0
    got = tn.row_median_batch(stack.movedim(0, -1))
    assert tn.row_median_batch.copies == (0 if n <= 32 else 1)
    assert torch.equal(got.view(torch.int32),
                       want.view(20, 15, 1).view(torch.int32))


def test_card_row_median_basic_stack_read_in_place(card):
    """BaSiC's darkfield median as ``models.basic._median0`` calls it, on
    the ``movedim`` view of a (12, 128, 128) stack: read in place (no
    copy), bit-equal to the contiguous copy's result."""
    from aind_smartspim_destripe_torch.models.basic import _median0

    g = torch.Generator(device="cpu").manual_seed(128)
    x = (torch.randn((12, 128, 128), generator=g) * 0.3).to(card)
    tops.reset_launches()
    tn.row_median_batch.copies = 0
    got = _median0(x)
    assert tn.row_median_batch.launches == 1
    assert tn.row_median_batch.copies == 0
    want = tn.row_median_batch(x.movedim(0, -1).contiguous())[..., 0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _sequential(a, b):
    """``a @ b`` as K sequential multiply-adds, one ``addcmul`` per term:
    every entry sums its terms in k order from 0."""
    K = a.shape[-1]
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,),
                                             b.shape[:-2] + (1, 1))[:-1]
                      + b.shape[-1:], device=a.device)
    for k in range(K):
        acc = torch.addcmul(acc, a[..., k:k + 1], b[..., k:k + 1, :])
    return acc


@pytest.mark.parametrize("form", ["planes @ operator^T", "operator @ planes",
                                  "sliced operator @ planes",
                                  "matrix @ matrix"])
def test_card_dense_matmul_fixed_order(card, form):
    """The dense-level product kernel on level 2 of a 1600x2000 plan's
    operand forms (a transposed operator, a sliced one, planes on either
    side): bit-equal to the term-by-term sum in k order, the same bits for
    one plane alone as inside the batch, and close to ``torch.matmul``."""
    g = torch.Generator(device="cpu").manual_seed(len(form))
    x = (torch.randn((3, 403, 503), generator=g) * 0.3).to(card)
    op_x = (torch.randn((254, 503), generator=g) / 503**0.5).to(card)
    an_y = (torch.randn((408, 403), generator=g) / 403**0.5).to(card)
    syn_y = (torch.randn((403, 408), generator=g) / 408**0.5).to(card)
    y = (torch.randn((3, 204, 503), generator=g) * 0.3).to(card)
    a, b = {
        "planes @ operator^T": (x, op_x.t()),
        "operator @ planes": (an_y, x),
        "sliced operator @ planes": (syn_y[:, 204:], y),
        "matrix @ matrix": (x[1], op_x.t()),
    }[form]
    tops.reset_launches()
    got = td.dense_matmul(a, b)
    assert td.dense_matmul.launches == 1
    assert got.is_contiguous()
    assert torch.equal(got, _sequential(a, b))
    _close(got, torch.matmul(a, b),
           scale=a.abs().max().item() * b.abs().max().item() * a.shape[-1])
    if got.ndim == 3:
        one = (td.dense_matmul(a[1:2], b) if a.ndim == 3
               else td.dense_matmul(a, b[1:2]))
        assert torch.equal(one, got[1:2])


@pytest.fixture(scope="module")
def dense_levels(card):
    """The dense levels' operators of a 1600x2000 plan on the card, with
    each level's input shape: {level: (h, w, an_x_lo, an_y, syn_y,
    syn_x_lo)}."""
    cfg = tf.FilterConfig(wavelet="db3", level=None, sigma=64,
                          max_threshold=3)
    plan = tf.build_plan(1600, 2000, cfg, cfg)
    consts = tf.device_constants(plan, card)
    n = plan.n_levels
    return {lvl: plan.ladder[n - lvl] + (
        consts["an_x_lo"][lvl], consts["an_y"][lvl],
        consts["syn_y"][n - 1 - lvl], consts["syn_x_lo"][n - 1 - lvl])
        for lvl in range(2, n)}


def _launches(fn, inputs, args, like, widths):
    """The C entry ``fn`` (input pointers, then the output's, then
    ``args(*widths)``) at the planned copy widths and at 4-byte copies,
    launched directly (the wrapper picks the first)."""
    from aind_smartspim_destripe_torch.ops.cuda_build import launch

    outs = []
    for v in {widths, (1,) * len(widths)}:
        out = torch.empty_like(like)
        launch(fn, like.device, *inputs, out.data_ptr(), *args(*v))
        outs.append(out)
    return outs


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("form", ["an_x", "an_y", "syn_y", "syn_x"])
@pytest.mark.parametrize("level", [2, 3, 4, 5, 6, 7])
def test_card_dense_matmul_every_level(card, dense_levels, level, form,
                                       batch):
    """The four products of every dense level of a 1600x2000 plan, with
    the step's operand forms (the operators transposed or sliced as the
    step passes them): bit-equal to the term-by-term sum in k order
    through the wrapper's launch and at each copy width, and a plane alone
    bit-equal to it inside the batch."""
    h, w, an_x_lo, an_y, syn_y, syn_x_lo = dense_levels[level]
    L = an_x_lo.shape[0]
    g = torch.Generator(device="cpu").manual_seed(level * 10 + len(form))

    def rand(*shape):
        return (torch.randn(shape, generator=g) * 0.3).to(card)

    a, b = {
        "an_x": lambda: (rand(batch, h, w), an_x_lo.t()),
        "an_y": lambda: (an_y, rand(batch, h, L)),
        "syn_y": lambda: (syn_y, rand(batch, syn_y.shape[1], L)),
        "syn_x": lambda: (rand(batch, syn_y.shape[0], L), syn_x_lo.t()),
    }[form]()
    want = _sequential(a, b)
    tops.reset_launches()
    got = td.dense_matmul(a, b)
    assert td.dense_matmul.launches == 1
    assert torch.equal(got, want)
    p = td.plan_dense_matmul(a.shape, a.stride(), b.shape, b.stride(),
                             a.data_ptr() % 8, b.data_ptr() % 8)
    for out in _launches("destripe_dense_matmul",
                         (a.data_ptr(), b.data_ptr()),
                         lambda *v: (p.batch, p.m, p.n, p.K, *p.sa, *p.sb,
                                     *v), got, (p.va, p.vb)):
        assert torch.equal(out, want)
    q = batch // 2
    one = (td.dense_matmul(a[q:q + 1], b) if a.ndim == 3
           else td.dense_matmul(a, b[q:q + 1]))
    assert torch.equal(one, got[q:q + 1])


def _plan_levels(h, w):
    cfg = tf.FilterConfig(wavelet="db3", level=None, sigma=64,
                          max_threshold=3)
    return tf.build_plan(h, w, cfg, cfg)


def _notch_witness(ch, thr, sel, cat):
    """The notch tail term by term: the kernel's median (exact, held
    against its twin above), the inpainted band, each plane's product with
    its operator as K sequential multiply-adds in k order, the delta."""
    n_out, w = thr.shape[0], ch.shape[-1]
    c = ch.repeat(n_out // ch.shape[0], 1, 1)
    stripes = torch.sqrt(c * c) > thr[:, None, None]
    inpainted = torch.where(stripes, tn.row_median_masked(ch, thr), c)
    prod = torch.stack([_sequential(inpainted[b], cat[:, s * w:(s + 1) * w])
                        for b, s in enumerate(sel.tolist())])
    return torch.where(stripes, 0.0, prod - c)


@pytest.mark.parametrize("wrapped", [False, True], ids=["single", "wrapped"])
@pytest.mark.parametrize("level", range(8))
def test_card_notch_delta_fixed_order(card, level, wrapped):
    """The notch tail on the shared GEMM tile at every level of a 1600x2000
    plan, single (an operator choice per plane) and wrapped (2B outputs of
    B planes, the dual form): bit-equal to the term-by-term k-order sum
    through the wrapper, and launched directly at 4-byte copies, which the
    order contract leaves free."""
    from aind_smartspim_destripe_torch.ops.cuda_build import launch

    plan = _plan_levels(1600, 2000)
    h, w = plan.ladder[plan.n_levels - 1 - level]
    g = torch.Generator(device="cpu").manual_seed(100 + level)
    B = 2
    ch = (torch.randn((B, h, w), generator=g) * 0.3).to(card)
    n_out = 2 * B if wrapped else B
    thr = torch.linspace(0.15, 0.6, n_out, device=card)
    thr[0] = 0.0  # every nonzero coefficient a stripe
    thr[-1] = 1e-20  # a cut under the smallest normal square
    sel = (torch.arange(n_out, device=card) >= B if wrapped
           else torch.arange(n_out, device=card) % 2 == 1).to(torch.int32)
    cat = (torch.randn((w, 2 * w), generator=g) / w**0.5).to(card)
    want = _notch_witness(ch, thr, sel, cat)
    tops.reset_launches()
    got = tn.notch_delta(ch, thr, sel, cat)
    assert tn.notch_delta.launches == 1
    assert torch.equal(got, want)
    v = tn.plan_notch_delta(n_out, h, w, ch.data_ptr() % 8,
                            cat.data_ptr() % 8)
    assert v == (2 if w % 2 == 0 else 1)
    med = tn.row_median_masked(ch, thr)
    out = torch.empty_like(want)
    launch("destripe_notch", card, ch.data_ptr(), med.data_ptr(),
           thr.data_ptr(), sel.data_ptr(), cat.data_ptr(), out.data_ptr(),
           n_out, B, h, w, 1)
    assert torch.equal(out, want)


def _k1_witness(x, start, coef, log1p):
    """K1 term by term: f(x) once per input, then each output's K taps as
    sequential multiply-adds in k order from 0."""
    xf = x.to(torch.float32)
    if log1p:
        xf = torch.log(1.0 + xf)
    L, K = coef.shape
    idx = start.to(torch.int64)
    acc = torch.zeros(x.shape[:-1] + (L,), device=x.device)
    for k in range(K):
        acc = torch.addcmul(acc, coef[:, k], xf[..., idx + k])
    return acc


def _k1_sums_witness(x, cut, L):
    """The float32 classifier sums in the kernel's order: per row, per
    group of 256 outputs, thread t's columns 2 (256 G + t) and +1 summed
    from 0 in float64, the group's 256 values by the halving tree, the
    (B, rows x groups) partials by torch's sum, rounded once."""
    B, H, W = x.shape
    gx = -(-L // 256)
    xd = torch.zeros((B, H, gx * 512), dtype=torch.float64, device=x.device)
    xd[..., :W] = x.to(torch.float64)
    fg = torch.zeros_like(xd, dtype=torch.bool)
    fg[..., :W] = x >= cut
    valid = torch.zeros_like(fg)
    valid[..., :W] = True
    terms = (fg.to(torch.float64), (valid & ~fg).to(torch.float64),
             torch.where(fg, xd, 0.0), torch.where(valid & ~fg, xd, 0.0))
    parts = []
    for t in terms:
        p = t.view(B, H, gx, 256, 2)
        s = p[..., 0] + p[..., 1]
        for stride in (128, 64, 32, 16, 8, 4, 2, 1):
            s = s[..., :stride] + s[..., stride:2 * stride]
        parts.append(s[..., 0].reshape(B, H * gx))
    return torch.stack(parts, dim=-1).sum(dim=1).to(torch.float32)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32],
                         ids=["u16", "f32"])
@pytest.mark.parametrize("level", [0, 1])
def test_card_k1_fixed_order(card, level, dtype):
    """K1 at levels 0 and 1 of a 1600x2000 plan (log1p at level 0), on
    uint16 and float32 input: bit-equal to its fmaf-chain witness, and
    its classifier sums exact (uint16: the integer totals, equal to the
    twin's float64 sums; float32: bit-equal to the same float64 sums taken
    in the kernel's order)."""
    ops = _ops((1600, 2000), level, card)
    start, coef = ops["k1_start"], ops["k1_coef"]
    W = ops["an_x_lo"].shape[1]
    L = coef.shape[0]
    g = torch.Generator(device="cpu").manual_seed(200 + level)
    x = torch.randint(0, 4000, (3, 37, W), generator=g)
    if dtype == torch.float32:
        x = x + torch.rand((3, 37, W), generator=g)
    x = x.to(dtype).to(card)
    cut = tf._classifier_cut_f32(400.0, 20.0, 0.3)
    log1p = level == 0
    want = _k1_witness(x, start, coef, log1p)
    tops.reset_launches()
    assert torch.equal(cb.an_x_lowpass_log1p(x, ops["an_x_lo"], start, coef,
                                             log1p), want)
    got, sums = cb.an_x_lowpass_log1p(x, ops["an_x_lo"], start, coef, log1p,
                                      cut)
    assert cb.an_x_lowpass_log1p.launches == 2
    assert torch.equal(got, want)
    _, twin = cb.an_x_lowpass_log1p_plain(x, ops["an_x_lo"], log1p, cut)
    if dtype == torch.uint16:
        assert torch.equal(sums, twin)
        assert int(sums[:, :2].sum()) == x.numel()
    else:
        assert torch.equal(sums, _k1_sums_witness(x, cut, L))
        _close(sums, twin)


def _y_band(hw, lvl, device, wavelet="db3"):
    """K2's and K3's band forms of analysis level ``lvl`` of an (h, w)
    plan, their input heights (H for K2, L for K3) and the level's width
    after its x pass."""
    cfg = tf.FilterConfig(wavelet=wavelet, level=None, sigma=64,
                          max_threshold=3)
    plan = tf.build_plan(*hw, cfg, cfg)
    bd = tf.device_constants(plan, device)[f"band{lvl}"]
    H = plan.height if lvl == 0 else plan.ladder[plan.n_levels - lvl][0]
    return bd, H, bd["k2_start"].shape[0], plan.ladder[-1 - lvl][1]


def _check_y_kernels(bd, H, L, B, Wc, card, seed):
    """K2 and K3 (with and without the correction half) on (B, ., Wc)
    inputs, each launched once, bit-equal to their k-order witnesses."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((B, H, Wc), generator=g) * 3).to(card)
    corr = (torch.randn((B, L, Wc), generator=g) * 0.01).to(card)
    delta = (torch.randn((B, L, Wc), generator=g) * 0.01).to(card)
    tops.reset_launches()
    # the dense operators are read by the plain twins only
    got = cb.an_y_pass(x, None, bd["k2_start"], bd["k2_lo"], bd["k2_hi"])
    assert cb.an_y_pass.launches == 1
    want = cb.an_y_pass_ordered(x, bd["k2_start"], bd["k2_lo"], bd["k2_hi"])
    for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(a, b)
    for c in (corr, None):
        got = cb.syn_y_pass(c, delta, None, bd["k3_start"], bd["k3_lo"],
                            bd["k3_hi"])
        assert torch.equal(got, cb.syn_y_pass_ordered(
            c, delta, bd["k3_start"], bd["k3_lo"], bd["k3_hi"]))
    assert cb.syn_y_pass.launches == 2


@pytest.mark.parametrize("hw,level", [((1600, 2000), 0), ((1600, 2000), 1),
                                      ((1001, 777), 0), ((640, 768), 0)],
                         ids=str)
def test_card_k2_k3_fixed_order(card, hw, level):
    """K2 and K3 at levels 0 and 1 of a 1600x2000 plan (rows of 1002 and
    503 columns: 8- and 4-byte vectors), at an odd height (1001 rows: a K2
    step of 1, partial runs of both) and at 640x768 (K2: 322 outputs, a
    partial run of 8; 386 columns): bit-equal to their witnesses."""
    bd, H, L, Wc = _y_band(hw, level, card)
    _check_y_kernels(bd, H, L, 3, Wc, card, 500 + level)


@pytest.mark.parametrize("width", [1000, 1002, 1001, 4, 3])
@pytest.mark.parametrize("batch", [1, 2])
def test_card_k2_k3_vector_widths(card, width, batch):
    """K2 and K3 on rows of 0, 2 and 1 columns mod 4 (16-, 8- and 4-byte
    vectors) and on rows narrower than a warp, one and two planes, with
    the 640x768 plan's level-0 band: bit-equal to their witnesses."""
    bd, H, L, _ = _y_band((640, 768), 0, card)
    _check_y_kernels(bd, H, L, batch, width, card, width + batch)


def test_card_k2_k3_unaligned_views(card):
    """Contiguous views that start 4 bytes past an aligned address take
    4-byte copies whatever the row pitch: bit-equal to their witnesses."""
    bd, H, L, _ = _y_band((640, 768), 0, card)
    g = torch.Generator(device="cpu").manual_seed(9)
    x = (torch.randn((2 * H * 1000 + 1,), generator=g) * 3).to(card)
    x = x[1:].view(2, H, 1000)
    d = (torch.randn((2 * L * 1000 + 1,), generator=g) * 0.01).to(card)
    d = d[1:].view(2, L, 1000)
    got = cb.an_y_pass(x, None, bd["k2_start"], bd["k2_lo"], bd["k2_hi"])
    want = cb.an_y_pass_ordered(x, bd["k2_start"], bd["k2_lo"], bd["k2_hi"])
    for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(a, b)
    got = cb.syn_y_pass(d, d, None, bd["k3_start"], bd["k3_lo"], bd["k3_hi"])
    assert torch.equal(got, cb.syn_y_pass_ordered(
        d, d, bd["k3_start"], bd["k3_lo"], bd["k3_hi"]))


@pytest.mark.parametrize("wavelet", ["db1", "db2", "db6", "db20"])
def test_card_k2_k3_other_wavelets(card, wavelet):
    """The run-time K instances: db1 (K2 K=2, K3 K=1), db2, db6 and db20
    (K2 K=40: more than 48 KB of shared memory per block) at level 0 of a
    1600x2000 plan, on 130 columns: bit-equal to their witnesses."""
    bd, H, L, _ = _y_band((1600, 2000), 0, card, wavelet)
    assert bd["k2_lo"].shape[1] != 6
    _check_y_kernels(bd, H, L, 2, 130, card, 7)


def _k4_witness(st, img, start, coef, **kw):
    """K4 term by term (``cuda_band.syn_x_exp_ordered``): each output's
    taps as sequential multiply-adds in k order from 0, then the plain
    twins' epilogue ops."""
    return cb.syn_x_exp_ordered(st, img, start, coef, **kw)


def _k4_inputs(rows, W, L, bi, dtype, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    img = torch.randint(0, 4000, (bi, rows, W), generator=g)
    if dtype == torch.float32:
        img = img + torch.rand((bi, rows, W), generator=g)
    flat = 1.0 + 0.2 * torch.rand((rows, W), generator=g)
    dark = torch.rand((rows, W), generator=g) * 40
    st = torch.randn((bi, rows, L), generator=g) * 0.01
    return (img.to(dtype).to(device), flat.to(device), dark.to(device),
            st.to(device))


_K4_MODES = {"bare": None, "exp": {}, "flat": "flat", "wrap": dict(wrap=True)}


# K4's cases beside a 1600x2000 plan's levels 0 and 1: (rows, width, image
# planes) with the width's tap-built band. The fused 16384x18000 plane's
# level-0 and level-1 widths (18 and 9 segments; at level 0, 17 rows of 4
# planes are 648 items, 1296 in the dual form, not a multiple of a 132-SM
# card's 396 blocks, so some blocks walk one item more); a ragged odd
# width, 2001 (L = 1003: uint16 rows that start at odd elements, partial
# last threads).
_K4_CASES = {"fused0": (17, 18000, 4), "fused1": (9, 9002, 4),
             "odd": (37, 2001, 3)}


def _k4_case(level, dtype, card):
    """(inputs, start, coef) of a test_card_k4_fixed_order case."""
    if level in (0, 1):
        ops = _ops((1600, 2000), level, card)
        W, L = ops["syn_x_lo"].shape
        return (_k4_inputs(37, W, L, 3, dtype, 400 + level, card),
                ops["k4_start"], ops["k4_coef"])
    from aind_smartspim_destripe_torch.ops import wavelets as tw
    from aind_smartspim_destripe_torch.parallel.halo import _k4_taps_band

    rows, W, bi = _K4_CASES[level]
    L = tw.dwt_coeff_len(W, 6)
    start, coef = (torch.from_numpy(a).to(card)
                   for a in _k4_taps_band(L, W, "db3"))
    return _k4_inputs(rows, W, L, bi, dtype, W, card), start, coef


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32],
                         ids=["u16", "f32"])
@pytest.mark.parametrize("mode", list(_K4_MODES))
@pytest.mark.parametrize("level", [0, 1, *_K4_CASES])
def test_card_k4_fixed_order(card, level, mode, dtype):
    """K4 at levels 0 and 1 of a 1600x2000 plan (W = 2000 and 1002: rows
    of W % 4 != 0 columns take the scalar head of its vector loads and
    stores) and at the _K4_CASES widths, in each mode, on uint16 and
    float32 images (37 rows: a partial row group): bit-equal to its
    witness; and, with B = 2 Bi, the dual form (correction b reads image
    plane b mod Bi)."""
    (img, flat, dark, st), start, coef = _k4_case(level, dtype, card)
    kw = _K4_MODES[mode]
    if kw is None:
        img, kw = None, {}
    elif kw == "flat":
        kw = dict(flat=flat, dark=dark)
    tops.reset_launches()
    got = cb.syn_x_exp(st, img, None, start, coef, **kw)
    assert cb.syn_x_exp.launches == 1
    assert torch.equal(got, _k4_witness(st, img, start, coef, **kw))
    if img is not None:
        st2 = torch.cat([st, st.flip(0) * 2.0])
        got = cb.syn_x_exp(st2, img, None, start, coef, **kw)
        assert torch.equal(got, _k4_witness(st2, img, start, coef, **kw))


@pytest.mark.parametrize("form", ["db6 640x768", "db20 18000"])
def test_card_k4_wide_band_fixed_order(card, form):
    """K4 on bands with more taps than the kernel holds in registers (it
    reads them from device memory): a db6 plan's level 0 (640x768, one
    segment), and db20's tap-built band at 18000 columns (K = 21, 18
    segments): bit-equal to its witness, bare and flat-field on uint16."""
    if form == "db6 640x768":
        cfg = tf.FilterConfig(wavelet="db6", level=None, sigma=64,
                              max_threshold=3)
        plan = tf.build_plan(640, 768, cfg, cfg)
        consts = tf.device_constants(plan, card)
        start = consts["band0"]["k4_start"]
        coef = consts["band0"]["k4_coef"]
        rows, bi = 9, 2
    else:
        from aind_smartspim_destripe_torch.ops import wavelets as tw
        from aind_smartspim_destripe_torch.parallel.halo import _k4_taps_band

        start, coef = (torch.from_numpy(a).to(card) for a in _k4_taps_band(
            tw.dwt_coeff_len(18000, 40), 18000, "db20"))
        rows, bi = 5, 4
    assert coef.shape[1] > 3
    W = coef.shape[0]
    L = int(start.max()) + coef.shape[1]
    img, flat, dark, st = _k4_inputs(rows, W, L, bi, torch.uint16, 6, card)
    for im, kw in ((None, {}), (img, dict(flat=flat, dark=dark))):
        got = cb.syn_x_exp(st, im, None, start, coef, **kw)
        assert torch.equal(got, _k4_witness(st, im, start, coef, **kw))


@pytest.mark.parametrize("width", [18000, 20480, 9002])
def test_card_k4_row_shard_fixed_order(card, width):
    """K4 on a row shard from the route's tap-built band form: a
    16384x18000 plane's levels 0 and 1 (18000 and 9002 columns), and rows
    of the 4096x20480 plane at the dense-x gate (the banded tier); bare,
    and flat-field on uint16: bit-equal to its witness."""
    from aind_smartspim_destripe_torch.ops import wavelets as tw
    from aind_smartspim_destripe_torch.parallel.halo import _k4_taps_band

    L = tw.dwt_coeff_len(width, 6)
    start_np, coef_np = _k4_taps_band(L, width, "db3")
    start = torch.from_numpy(start_np).to(card)
    coef = torch.from_numpy(coef_np).to(card)
    img, flat, dark, st = _k4_inputs(19, width, L, 1, torch.uint16, width,
                                     card)
    for im, kw in ((None, {}), (img, dict(flat=flat, dark=dark))):
        tops.reset_launches()
        got = cb.syn_x_exp_chunked(st, im, None, start, coef, **kw)
        assert cb.syn_x_exp_chunked.launches == 1
        assert torch.equal(got, _k4_witness(st, im, start, coef, **kw))


def test_card_k1_row_shard_fixed_order(card):
    """K1 on a row shard of a 16384x18000 plane's level 0 (the route's
    band form built from the filter taps, nine blocks of 1024 outputs per
    row): bit-equal to its witness on uint16 input with log1p and on
    float32 input without."""
    from aind_smartspim_destripe_torch.parallel.halo import _k1_taps_band

    start_np, coef_np = _k1_taps_band(18000, "db3")
    start = torch.from_numpy(start_np).to(card)
    coef = torch.from_numpy(coef_np).to(card)
    g = torch.Generator(device="cpu").manual_seed(300)
    x = torch.randint(0, 4000, (1, 19, 18000), generator=g).to(
        torch.uint16).to(card)
    for src, log1p in ((x, True), (x.to(torch.float32) * 0.01, False)):
        tops.reset_launches()
        got = cb.an_x_lowpass_chunked(src, None, start, coef, log1p=log1p)
        assert cb.an_x_lowpass_chunked.launches == 1
        assert torch.equal(got, _k1_witness(src, start, coef, log1p))


def _level_ops(h, w, lvl):
    """One level's dense operators, as ``ops.filter.device_constants`` builds
    them, without the plan's full-width operators (a wide plan's finest
    x operator is gigabytes)."""
    from aind_smartspim_destripe_torch.ops import wavelets as tw

    plan = _plan_levels(h, w)
    n = plan.n_levels
    hi, wi = (h, w) if lvl == 0 else plan.ladder[n - lvl]
    L_h, L_w = plan.ladder[n - 1 - lvl]
    return plan, (hi, wi), {
        "an_x_lo": tw.analysis_operator(wi, "db3")[:L_w],
        "an_y": tw.analysis_operator(hi, "db3"),
        "syn_y": tw.synthesis_operator(L_h, "db3")[:hi],
        "syn_x_lo": tw.synthesis_operator(L_w, "db3")[:wi, :L_w],
    }


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("form", ["an_x", "an_y", "syn_y", "syn_x"])
def test_card_dense_matmul_long_k(card, form, batch):
    """The four level-2 products of a 2000x16000 plan, where the an_x
    product runs K = 4003 (a plane whose short side is under 560 puts K in
    the thousands on the 64 x 64 tile): bit-equal to the term-by-term sum
    in k order, and a plane alone bit-equal to it inside the batch."""
    _, (h, w), o = _level_ops(2000, 16000, 2)
    assert (h, w) == (503, 4003)
    g = torch.Generator(device="cpu").manual_seed(400 + len(form))
    ops = {k: torch.from_numpy(v).to(card) for k, v in o.items()}
    L = ops["an_x_lo"].shape[0]

    def rand(*shape):
        return (torch.randn(shape, generator=g) * 0.3).to(card)

    a, b = {
        "an_x": lambda: (rand(batch, h, w), ops["an_x_lo"].t()),
        "an_y": lambda: (ops["an_y"], rand(batch, h, L)),
        "syn_y": lambda: (ops["syn_y"], rand(batch, ops["syn_y"].shape[1],
                                             L)),
        "syn_x": lambda: (rand(batch, ops["syn_y"].shape[0], L),
                          ops["syn_x_lo"].t()),
    }[form]()
    if form == "an_x":
        assert a.shape[-1] == 4003
    tops.reset_launches()
    got = td.dense_matmul(a, b)
    assert td.dense_matmul.launches == 1
    assert torch.equal(got, _sequential(a, b))
    q = batch // 2
    one = (td.dense_matmul(a[q:q + 1], b) if a.ndim == 3
           else td.dense_matmul(a, b[q:q + 1]))
    assert torch.equal(one, got[q:q + 1])


@pytest.mark.parametrize("rows,w", [(259, 517), (70, 258), (130, 131),
                                    (129, 256)], ids=str)
def test_card_notch_select_fixed_order(card, rows, w):
    """The per-plane notch product with mixed operator choices, at widths
    of every residue mod 4 (the no-cells operator starts w columns into
    the bank, so its rows are misaligned for 16-byte copies) and row counts
    off the tile: bit-equal to the term-by-term sum in k order, through the
    wrapper and through the kernel at 8-byte (even w) and 4-byte
    copies."""
    g = torch.Generator(device="cpu").manual_seed(rows + w)
    x = (torch.randn((3, rows, w), generator=g) * 0.3).to(card)
    bank = (torch.randn((w, 2 * w), generator=g) / w**0.5).to(card)
    sel = torch.tensor([1, 0, 1], dtype=torch.int32, device=card)
    want = torch.stack([_sequential(x[b], bank[:, s * w:(s + 1) * w])
                        for b, s in enumerate(sel.tolist())])
    tops.reset_launches()
    got = tn.notch_select(x, sel, bank)
    assert tn.notch_select.launches == 1
    assert torch.equal(got, want)
    v = tn.plan_notch_select(3, rows, w, x.data_ptr(), bank.data_ptr())
    assert v == (2 if w % 2 == 0 else 1)
    for out in _launches("destripe_notch_select",
                         (x.data_ptr(), sel.data_ptr(), bank.data_ptr()),
                         lambda v: (3, rows, w, v), got, (v,)):
        assert torch.equal(out, want)


@pytest.mark.parametrize("hw", [(640, 768), (1600, 2000)], ids=str)
def test_card_plane_output_independent_of_batch(card, hw):
    """The step on the card gives a plane the same bits alone as in a
    batch of four: every stage, the dense levels' products included, sums
    in an order that does not depend on the batch."""
    h, w = hw
    plan = tf.build_plan(h, w, tf.FilterConfig(wavelet="db3", sigma=64,
                                               max_threshold=3),
                         tf.FilterConfig(wavelet="db3", sigma=128,
                                         max_threshold=12))
    rng = np.random.default_rng(23)
    x = np.clip(300 + rng.normal(size=(4, h, 1)) * 50
                + rng.normal(size=(4, h, w)) * 10
                + np.array([0, 2800, 0, 2800])[:, None, None],
                0, 65535).astype(np.uint16)
    xs = torch.from_numpy(x).to(card)
    tops.reset_launches()
    whole = tf.destripe_batch(plan, xs, 2500.0, wrap=True)
    assert td.dense_matmul.launches > 0
    for p in range(4):
        alone = tf.destripe_batch(plan, xs[p:p + 1], 2500.0, wrap=True)
        assert torch.equal(alone, whole[p:p + 1]), p


@pytest.mark.parametrize("epilogue", ["flat", "wrap"])
def test_card_destripe_batch_matches_cpu(card, epilogue):
    """The whole step on the card (K1-K4 at level 0, the histogram and
    notch kernels at every level) against the plain path on the CPU: within
    1 LSB apart from threshold flips (budget 1e-4 of the pixels)."""
    h, w = 640, 768
    cfg_c = tf.FilterConfig(wavelet="db3", sigma=64, max_threshold=3)
    cfg_n = tf.FilterConfig(wavelet="db3", sigma=128, max_threshold=12)
    plan = tf.build_plan(h, w, cfg_c, cfg_n)
    rng = np.random.default_rng(21)
    x = np.clip(300 + rng.normal(size=(4, h, 1)) * 50
                + rng.normal(size=(4, h, w)) * 10
                + np.array([0, 2800, 0, 2800])[:, None, None],
                0, 65535).astype(np.uint16)
    kw = dict(wrap=True)
    if epilogue == "flat":
        kw = dict(flat=(1.0 + 0.2 * rng.random((h, w))).astype(np.float32),
                  dark=np.full((h, w), 3.0, np.float32))
    tops.reset_launches()
    got = tf.destripe_batch(plan, torch.from_numpy(x).to(card), 2500.0,
                            **kw).cpu().numpy()
    single = [k for k in tops.kernels()
              if k is not tbl.blend_smooth_mix and k not in OFF_PLANE]
    assert all(k.launches > 0 for k in single)
    want = tf.destripe_batch(plan, torch.from_numpy(x), 2500.0, **kw).numpy()
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (d > 1).mean() <= 1e-4, f"{(d > 1).mean():.2%} flipped"


# the blend: the step's plane, ragged tiles on both axes, a plane under the
# box width on both axes, and a width that is not a multiple of 4
BLEND_CASES = [((3, 1600, 2000), torch.uint16), ((2, 37, 203), torch.float32),
               ((2, 200, 260), torch.uint16), ((1, 5, 9), torch.uint16),
               ((2, 61, 1001), torch.float32)]


def _blend_case(shape, dtype, card, rows=None):
    """x, the stacked band pair, centres and the emitted rows' fields."""
    g = torch.Generator(device="cpu").manual_seed(shape[1] * 7 + shape[2])
    B = shape[0]
    x = torch.randint(0, 4000, shape, generator=g).to(dtype).to(card)
    both = (torch.randn((2 * B,) + shape[1:], generator=g) * 300
            + 500).to(card)
    centers = (torch.rand(B, generator=g) * 300 + 100).to(card)
    n = shape[1] if rows is None else rows[1]
    flat = (1.0 + 0.5 * torch.rand((n, shape[2]), generator=g)).to(card)
    dark = (torch.rand((n, shape[2]), generator=g) * 400).to(card)
    return x, both, centers, flat, dark


def _blend_modes(card, shape, dtype, rows=None):
    """The kernel in each mode against its twin composition (the twin, the
    row slice, the epilogue), and each fused form bit-equal to the bare
    kernel followed by the epilogue on the card."""
    x, both, centers, flat, dark = _blend_case(shape, dtype, card, rows)
    B = shape[0]
    bare = tbl.blend_smooth_mix(x, both, None, centers, 100.0, out_rows=rows)
    twin = tbl.blend_bands(x, both[:B], both[B:], centers, 100.0)
    if rows is not None:
        twin = twin[:, rows[0]:rows[0] + rows[1]]
    _close(bare, twin, scale=both.abs().max().item())
    for kw, epi in ((dict(flat=flat, dark=dark),
                     lambda y: tf.flatfield_correction(y, flat, dark)),
                    (dict(wrap=True), tf.wrap_cast)):
        got = tbl.blend_smooth_mix(x, both, None, centers, 100.0,
                                   out_rows=rows, **kw)
        assert got.dtype == torch.uint16 and got.shape == bare.shape
        assert torch.equal(got, epi(bare))
        d = (got.to(torch.int32) - epi(twin).to(torch.int32)).abs()
        if "wrap" in kw:  # modulo 2^16: 65535 and 0 are 1 LSB apart
            d = torch.minimum(d, 65536 - d)
        assert d.max().item() <= 1


@pytest.mark.parametrize("shape,dtype", BLEND_CASES)
def test_card_blend_matches_twin(card, shape, dtype):
    """The blend kernel against its twin, both bands read from the stacked
    pair in place, bare and with each fused epilogue."""
    _blend_modes(card, shape, dtype)
    x, both, centers, _, _ = _blend_case(shape, dtype, card)
    with pytest.raises(ValueError, match="radius"):
        tbl.blend_smooth_mix(x, both, None, centers, 100.0, smooth_radius=4)


@pytest.mark.parametrize("shape,rows", [((2, 48, 203), (8, 32)),
                                        ((1, 200, 260), (0, 192)),
                                        ((1, 8208, 2000), (8, 8192)),
                                        ((2, 12, 9), (11, 1))])
def test_card_blend_window_rows(card, shape, rows):
    """A row shard's window: the kernel emits rows [first, first + count)
    with the box clamped at the window's edges, as the twin's slice."""
    _blend_modes(card, shape, torch.uint16, rows)


def test_card_blend_split_bands_and_launches(card):
    """Separate fore and back buffers read as the stacked pair's halves;
    each call counts one launch; an empty row range launches nothing."""
    x, both, centers, flat, dark = _blend_case((2, 37, 203), torch.uint16,
                                               card)
    tops.reset_launches()
    a = tbl.blend_smooth_mix(x, both, None, centers, 100.0, flat=flat,
                             dark=dark)
    b = tbl.blend_smooth_mix(x, both[:2].clone(), both[2:].clone(), centers,
                             100.0, flat=flat, dark=dark)
    assert torch.equal(a, b) and tbl.blend_smooth_mix.launches == 2
    empty = tbl.blend_smooth_mix(x, both, None, centers, 100.0,
                                 out_rows=(5, 0), wrap=True)
    assert empty.shape == (2, 0, 203) and tbl.blend_smooth_mix.launches == 2


def test_card_blend_div17_is_ieee_division(card):
    """The kernel's division by 17 is bit-equal to IEEE division on every
    float32 from +0 to 17.0 (the range of a sum of 17 sigmoid values)."""
    assert tbl.div17_mismatches(card) == (0, -1)


def test_card_wrapped_forms_match_twins(card):
    """K4, the masked median and the notch tail in their dual forms (2B
    outputs from B planes) against their twins, at level 0 of 1600x2000."""
    ops = _ops((1600, 2000), 0, card)
    g = torch.Generator(device="cpu").manual_seed(7)
    B = 2
    L = ops["an_x_lo"].shape[0]
    x = torch.randint(0, 4000, (B, 1600, 2000), generator=g).to(
        torch.uint16).to(card)
    st = (torch.randn((2 * B, 1600, L), generator=g) * 0.01).to(card)
    _close(cb.syn_x_exp(st, x, ops["syn_x_lo"], ops["k4_start"],
                        ops["k4_coef"]),
           cb.syn_x_exp_plain(st, x, ops["syn_x_lo"]))
    ch = (torch.randn((B, 802, 1002), generator=g) * 0.3).to(card)
    thr = torch.tensor([0.2, 0.35, 0.5, 0.9], device=card)
    sel = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=card)
    assert torch.equal(tn.row_median_masked(ch, thr),
                       tn.row_median_masked_plain(ch, thr))
    cat = (torch.randn((1002, 2004), generator=g) / 1002**0.5).to(card)
    got = tn.notch_delta(ch, thr, sel, cat)
    assert got.shape == (2 * B, 802, 1002)
    _close(got, tn.notch_delta_plain(ch, thr, sel, cat),
           scale=ch.abs().max().item())


def test_card_dual_band_matches_cpu(card):
    """The dual-band step on the card (every kernel, the blend and the
    wrapped forms included) against the plain path on the CPU: within 1
    LSB apart from threshold flips (budget 1e-4 of the pixels)."""
    h, w = 640, 768
    plan = tf.build_plan(h, w, tf.FilterConfig(wavelet="db3", sigma=64,
                                               max_threshold=3),
                         tf.FilterConfig(wavelet="db3", sigma=128,
                                         max_threshold=12))
    rng = np.random.default_rng(22)
    x = np.clip(300 + rng.normal(size=(3, h, 1)) * 50
                + rng.normal(size=(3, h, w)) * 10
                + np.array([0, 2800, 0])[:, None, None],
                0, 65535).astype(np.uint16)
    tops.reset_launches()
    got = tdb.dual_band_destripe_batch(plan, torch.from_numpy(x).to(card),
                                       100.0, -1.0).cpu().numpy()
    assert all(k.launches > 0 for k in tops.kernels() if k not in OFF_PLANE)
    want = tdb.dual_band_destripe_batch(plan, torch.from_numpy(x), 100.0,
                                        -1.0).numpy()
    d = np.abs(got.astype(np.float64) - want)
    assert (d > 1).mean() <= 1e-4, f"{(d > 1).mean():.2%} flipped"


def test_card_halo_kernels_match_twins(card):
    """The row-sharded route's kernel calls against their twins: K1 and K4
    on a row shard from the band form alone (u16 with log1p, f32 without;
    bare and flat-field), the per-plane notch product with mixed operator
    choices, and the histogram with a row bound that cuts a shard's pad
    rows (exact integer counts)."""
    ops = _ops((1024, 2048), 0, card)
    g = torch.Generator(device="cpu").manual_seed(31)
    rows, w = 517, 2048
    L = ops["an_x_lo"].shape[0]
    x = torch.randint(0, 4000, (1, rows, w), generator=g).to(
        torch.uint16).to(card)
    for src, log1p in ((x, True), (x.to(torch.float32).log1p(), False)):
        got = cb.an_x_lowpass_chunked(src, None, ops["k1_start"],
                                      ops["k1_coef"], log1p=log1p)
        _close(got, cb.an_x_lowpass_log1p_plain(src, ops["an_x_lo"], log1p))
    st = (torch.randn((1, rows, L), generator=g) * 0.01).to(card)
    flat = (1.0 + 0.2 * torch.rand((rows, w), generator=g)).to(card)
    dark = torch.full((rows, w), 3.0, device=card)
    for img, kw in ((None, {}), (x, dict(flat=flat, dark=dark))):
        got = cb.syn_x_exp_chunked(st, img, None, ops["k4_start"],
                                   ops["k4_coef"], **kw)
        _close(got, cb.syn_x_exp_plain(st, img, ops["syn_x_lo"], **kw))
    ch = (torch.randn((3, 259, 1026), generator=g) * 0.3).to(card)
    bank = (torch.randn((1026, 2052), generator=g) / 1026**0.5).to(card)
    sel = torch.tensor([1, 0, 1], dtype=torch.int32, device=card)
    _close(tn.notch_select(ch, sel, bank), tn.notch_select_plain(ch, sel, bank),
           scale=ch.abs().max().item())
    a = ch.abs()[:, :200]
    lo = a.amin(dim=(1, 2)) ** 2
    span = a.amax(dim=(1, 2)) ** 2 - lo
    got = th.histogram256_batch(ch, lo, span, square=True, row_bound=200)
    want = th.histogram256_batch_plain(ch, lo, span, square=True,
                                       row_bound=200)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got.sum()) == 3 * 200 * 1026


@pytest.mark.parametrize("dual", [False, True])
def test_card_halo_step_matches_plane_path(card, dual, monkeypatch):
    """The row-sharded step on a two-entry mesh of one card (the byte
    threshold lowered so a 1024 x 2048 plane takes the route) against the
    single-device plane path on the card: within 1 LSB apart from threshold
    flips (budget 1e-4 of the pixels)."""
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    monkeypatch.setenv("DESTRIPE_HALO_THRESHOLD_BYTES", "1024")
    h, w = 1024, 2048
    plan = tf.build_plan(h, w, tf.FilterConfig(wavelet="db3", sigma=64,
                                               max_threshold=3),
                         tf.FilterConfig(wavelet="db3", sigma=128,
                                         max_threshold=12))
    rng = np.random.default_rng(23)
    x = np.clip(300 + rng.normal(size=(2, h, 1)) * 50
                + rng.normal(size=(2, h, w)) * 10
                + np.array([0, 2800])[:, None, None], 0, 65535).astype(
        np.uint16)
    flat = (1.0 + 0.2 * rng.random((h, w))).astype(np.float32)
    dark = np.full((h, w), 3.0, np.float32)
    outs = []
    for mesh in ([card, card], [card]):
        step = make_device_step(plan, 2500.0, True, devices=mesh, dual=dual)
        assert getattr(step, "shards_rows", False) == (len(mesh) == 2)
        tops.reset_launches()
        outs.append(step.to_host(step(step.put(x), step.put_const(flat),
                                      step.put_const(dark))))
        if len(mesh) == 2:
            assert cb.an_x_lowpass_chunked.launches > 0
            assert cb.syn_x_exp_chunked.launches > 0
            assert tn.notch_select.launches > 0
            assert th.histogram256_batch.launches > 0
            assert tn.row_median_masked.launches > 0
    d = np.abs(outs[0].astype(np.int64) - outs[1].astype(np.int64))
    assert (d > 1).mean() <= 1e-4, f"{(d > 1).mean():.2%} flipped"


@pytest.mark.parametrize("dual", [False, True])
def test_card_plane_step_never_waits_on_host(card, dual):
    """The plane step launches its whole batch without one synchronising
    call, so a plane-sharded step's devices work at once rather than in
    turn (torch's sync debug mode raises at any such call)."""
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    h, w = 1024, 2048
    plan = tf.build_plan(h, w, tf.FilterConfig(wavelet="db3", sigma=64,
                                               max_threshold=3),
                         tf.FilterConfig(wavelet="db3", sigma=128,
                                         max_threshold=12))
    rng = np.random.default_rng(29)
    x = np.clip(300 + rng.normal(size=(2, h, w)) * 10
                + np.array([0, 2800])[:, None, None], 0, 65535).astype(
        np.uint16)
    flat = (1.0 + 0.2 * rng.random((h, w))).astype(np.float32)
    step = make_device_step(plan, 2500.0, True, devices=[card, card],
                            dual=dual)
    imgs = step.put(x)
    fields = (step.put_const(flat), step.put_const(np.ones_like(flat)))
    step(imgs, *fields)  # first call: kernel build and GEMM handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = step(imgs, *fields)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step.to_host(res).shape == x.shape


def _masked_keys_witness(x, thr):
    """The masked median with the kernel's order, on the CPU: output plane
    b reads band plane b mod B with ``sqrt(x*x) > thr[b]`` read as +0.0,
    then :func:`_median_keys_witness`."""
    x, thr = x.cpu(), thr.cpu()
    c = x.repeat(thr.shape[0] // x.shape[0], 1, 1)
    stripes = torch.sqrt(c * c) > thr[:, None, None]
    return _median_keys_witness(torch.where(stripes, torch.zeros_like(c), c))


def _masked_rows(B, h, w, seed):
    """B planes of h rows of w values, each row of one kind: normal values,
    integer ties with both signs of zero, a constant row, or half zeros."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((B, h, w), generator=g) * 0.5
    kind = torch.randint(0, 4, (B, h, 1), generator=g)
    ties = torch.round(torch.randn((B, h, w), generator=g) * 2)
    ties = torch.where(torch.rand((B, h, w), generator=g) < 0.3, -ties, ties)
    x = torch.where(kind == 1, ties, x)
    x = torch.where(kind == 2, torch.full_like(x, 0.375), x)
    half = torch.rand((B, h, w), generator=g) < 0.5
    x = torch.where((kind == 3) & half, torch.zeros_like(x), x)
    x.view(-1)[1::13] = -0.0
    return x


# every route: warp (<= 1024: 1..32 keys per lane), block staged (<= 11264)
# and block from device memory, and the edges between
@pytest.mark.parametrize("w", [1, 2, 12, 20, 31, 32, 33, 36, 64, 65, 67,
                               129, 254, 503, 1002, 1023, 1024, 1025, 2049,
                               4503, 11264, 11265])
@pytest.mark.parametrize("k_out", [1, 2])
@pytest.mark.parametrize("offset", [0, 1])
def test_card_row_median_masked_routes_bit_equal(card, w, k_out, offset):
    """The masked median on every route, plain (B thresholds) and wrapped
    (2B), from a base one element past an aligned one (a slice): bit-equal
    to the key-order witness (a masked value reads as +0.0) and equal to
    the plain twin. Thresholds per output plane: finite ones, NaN and +inf
    (nothing masked), negative (everything masked) and 0."""
    B, h = 4, 37
    x = _masked_rows(B, h, w, w + 7 * k_out)
    buf = torch.empty(B * h * w + 1)
    buf[offset:offset + x.numel()] = x.view(-1)
    xc = buf.to(card)[offset:offset + x.numel()].view(B, h, w)
    thr = torch.tensor([0.3, float("nan"), -1.0, float("inf"), 0.0, 0.6,
                        2.0, 1e-3][:k_out * B], device=card)
    route = tn.masked_median_route(w)[0]
    assert route == (tn.WARP if w <= 1024 else
                     tn.STAGED if w <= 11264 else tn.L2)
    tops.reset_launches()
    got = tn.row_median_masked(xc, thr)
    assert tn.row_median_masked.launches == 1
    assert got.shape == (k_out * B, h, 1)
    want = _masked_keys_witness(xc, thr)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, tn.row_median_masked_plain(xc, thr))


@pytest.mark.parametrize("w", [20, 503, 1002, 9002])
def test_card_row_median_masked_value_classes(card, w):
    """Rows with +-inf and NaN values (NaN above +inf, never masked), all
    masked rows and rows past 32 equal keys at the median, on the warp
    route (1, 16 and 32 keys per lane) and the block route: bit-equal to
    the key-order witness."""
    B, h = 2, 9
    x = _masked_rows(B, h, w, 3 * w)
    flat = x.view(-1)
    flat[2::37] = float("inf")
    flat[3::41] = -float("inf")
    flat[5::53] = float("nan")
    x[:, 0] = 7.0  # all over 0.3: wholly masked
    x[:, 1, : w // 2 + 2] = -0.25  # more than half one key
    xc = x.to(card)
    thr = torch.tensor([0.3, float("inf"), 0.3, -1.0], device=card)
    got = tn.row_median_masked(xc, thr)
    want = _masked_keys_witness(xc, thr)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_card_row_median_masked_refusals(card):
    """Shapes the routes cannot take raise on the host: rows of no values,
    and more output planes than the block route's grid.y holds."""
    with pytest.raises(ValueError, match="w >= 1"):
        tn.row_median_masked(torch.empty((2, 3, 0), device=card),
                             torch.zeros(2, device=card))
    with pytest.raises(ValueError, match="grid"):
        tn.row_median_masked(torch.zeros((1, 1, 2000), device=card),
                             torch.zeros(65536, device=card))


def _offset(t, offset, card):
    """``t`` on the card, its base ``offset`` elements past an aligned one:
    a contiguous slice of a flat buffer."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype)
    buf[offset:] = t.reshape(-1)
    return buf.to(card)[offset:].view(t.shape)


@pytest.mark.parametrize("shape", [(3, 37, 203), (2, 403, 503), (1, 1, 7),
                                   (5, 11, 12), (64, 17, 20), (1, 3, 2),
                                   (2, 802, 1002)], ids=str)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_card_histogram_forms_exact(card, shape, offset):
    """The histogram on f32 (plain and squared) and raw uint16 planes of odd
    and even lengths, from bases 0, 1 and 3 elements past an aligned one
    (16-byte loads after a scalar head, a scalar tail): equal to the twin.
    Ranges leave values outside [lo, lo + span] on both sides; uint16 0 and
    65535 included."""
    B = shape[0]
    g = torch.Generator(device="cpu").manual_seed(sum(shape) + offset)
    x = torch.randn(shape, generator=g) * 3.0
    xc = _offset(x, offset, card)
    lo = torch.linspace(-2.0, 0.5, B, device=card)
    span = torch.linspace(4.0, 0.01, B, device=card)
    for square in (False, True):
        assert torch.equal(
            th.histogram256_batch(xc, lo, span, square=square),
            th.histogram256_batch_plain(xc, lo, span, square=square))
    u16 = torch.randint(0, 65536, shape, generator=g, dtype=torch.int32)
    u16.view(-1)[:2] = torch.tensor([0, 65535])
    uc = _offset(u16.to(torch.uint16), offset, card)
    lo16 = torch.linspace(0.0, 20000.0, B, device=card)
    span16 = torch.linspace(65535.0, 100.0, B, device=card)
    got = th.histogram256_batch(uc, lo16, span16)
    assert torch.equal(got, th.histogram256_batch_plain(uc, lo16, span16))
    assert bool((got.sum(1) == shape[1] * shape[2]).all())


@pytest.mark.parametrize("shape,bound", [((1, 4097, 9002), 4097),
                                         ((1, 2050, 4503), 2049),
                                         ((1, 517, 2048), 200),
                                         ((3, 259, 1026), 0)], ids=str)
def test_card_histogram_row_bound_one_plane(card, shape, bound):
    """One wide plane (a halo shard, the grid filling the card) and a few,
    each with a row bound: equal to the twin, the counts summing to the
    bound's values."""
    g = torch.Generator(device="cpu").manual_seed(bound)
    ch = (torch.randn(shape, generator=g) * 0.5).to(card)
    a = ch[:, :max(bound, 1)].abs()
    lo = a.amin(dim=(1, 2)) ** 2
    span = a.amax(dim=(1, 2)) ** 2 - lo
    tops.reset_launches()
    got = th.histogram256_batch(ch, lo, span, square=True, row_bound=bound)
    assert th.histogram256_batch.launches == (1 if bound else 0)
    assert torch.equal(got, th.histogram256_batch_plain(
        ch, lo, span, square=True, row_bound=bound))
    assert int(got.sum()) == shape[0] * bound * shape[2]


def test_card_histogram_refusals(card):
    """More planes than the grid's 65535 and more bins than the kernel's
    byte counters hold raise on the host."""
    x = torch.zeros((65536, 1, 1), device=card)
    t = torch.zeros(65536, device=card)
    with pytest.raises(ValueError, match="grid"):
        th.histogram256_batch(x, t, t + 1)
    with pytest.raises(ValueError, match="nbins"):
        th.histogram256_batch(x[:1], t[:1], t[:1] + 1, nbins=257)


@pytest.mark.parametrize("w", [1002, 2254, 4503, 9002])
def test_card_notch_cat_within_an_ulp(card, w):
    """The notch operators the plane step builds on the card past the host
    gate (cuFFT in float64): within a float32 ulp of the host's, of
    max(|entry|, 2^-20); at or under the gate (the accepted cells' widths)
    the host's, bit for bit. The host takes seconds at 9002 columns."""
    sigmas = (w * 64.0 / 16384, w * 128.0 / 16384)
    got = fft_notch.notch_cat(w, sigmas, card)
    host = fft_notch.notch_cat(w, sigmas)
    if w <= fft_notch.NOTCH_HOST_MAX_W:
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, host)
        return
    assert got.device.type == "cuda" and got.dtype == torch.float32
    tol = np.spacing(np.maximum(np.abs(host), np.float32(2 ** -20)))
    assert (np.abs(got.cpu().numpy() - host) <= tol).all()


def test_card_stitched_plane_constants(card):
    """The plane step's constants of a 16384 x 18000 plane: the banded
    levels 0-4 hold band forms alone, the notch operators are built on
    the card, and the whole is under 1 GB there."""
    plan = tf.build_plan(16384, 18000, tf.FilterConfig(sigma=64,
                                                       max_threshold=3),
                         tf.FilterConfig(sigma=128, max_threshold=12))
    assert plan.banded_levels() == (0, 1, 2, 3, 4)
    consts = tf.device_constants(plan, card)
    n = plan.n_levels
    for lvl in range(n):
        banded = lvl in plan.banded_levels()
        assert (f"band{lvl}" in consts) == banded
        for key, idx in (("an_y", lvl), ("an_x_lo", lvl),
                         ("syn_y", n - 1 - lvl), ("syn_x_lo", n - 1 - lvl)):
            assert (consts[key][idx] is None) == banded
    # every level's notch runs from its factors: no (w, 2w) operator
    assert all(isinstance(c, fft_notch.NotchFactors)
               for c in consts["notch_cat"])
    for (_, w), sigmas, (p, ds, ranks) in zip(
            plan.ladder, plan.notch_sigmas(), consts["notch_cat"]):
        want = fft_notch.notch_factors(w, sigmas)
        assert ranks == want.ranks
        assert torch.equal(p.cpu(), torch.from_numpy(want.p))
        assert torch.equal(ds.cpu(), torch.from_numpy(want.ds))
    factor_tensors = [t for c in consts["notch_cat"] for t in c[:2]]
    tensors = [t for k, v in consts.items() if k != "notch_cat" for t in (
        v.values() if k.startswith("band") else v) if t is not None]
    tensors += factor_tensors
    assert all(t.device.type == "cuda" for t in tensors)
    factors = sum(t.numel() * t.element_size() for t in factor_tensors)
    # 80.3 MB over the 11 levels, 60 MB of it level 0's (9002, 556) p and
    # (1112, 9002) ds, in place of the dense operators' 865 MB (notch_cat)
    assert factors < 8.5e7
    assert sum(t.numel() * t.element_size() for t in tensors) < 1.0e8


def _lowrank_witness(ch, thr, sel, p, ds, ranks):
    """The exact-rank notch tail term by term: the kernel's median (exact,
    held against its twin above), the inpainted band, each plane's
    projection over the w terms and its synthesis over its rank's, as
    sequential multiply-adds in k order, 0 at the stripes."""
    n_out, rp = thr.shape[0], p.shape[1]
    c = ch.repeat(n_out // ch.shape[0], 1, 1)
    stripes = torch.sqrt(c * c) > thr[:, None, None]
    inpainted = torch.where(stripes, tn.row_median_masked(ch, thr), c)
    out = []
    for b, s in enumerate(sel.tolist()):
        r = ranks[s]
        y = _sequential(inpainted[b], p[:, :r])
        out.append(_sequential(y, ds[s * rp:s * rp + r]))
    return torch.where(stripes, 0.0, torch.stack(out))


def _lowrank_inputs(card, level, B, n_out, seed, offset=0):
    """A band of the 16384 x 18000 plan's level ``level`` (B planes, from
    ``offset`` floats into its buffer), ``n_out`` thresholds (the first
    0.0: every nonzero coefficient a stripe) and the level's factors."""
    plan = tf.build_plan(16384, 18000, tf.FilterConfig(sigma=64,
                                                       max_threshold=3),
                         tf.FilterConfig(sigma=128, max_threshold=12))
    i = plan.n_levels - 1 - level
    (h, w), sigmas = plan.ladder[i], plan.notch_sigmas()[i]
    g = torch.Generator(device="cpu").manual_seed(seed)
    buf = (torch.randn(offset + B * h * w, generator=g) * 0.3).to(card)
    ch = buf[offset:].view(B, h, w)
    thr = torch.linspace(0.2, 0.6, n_out, device=card)
    thr[0] = 0.0
    p, ds, ranks = fft_notch.notch_factors(w, sigmas)
    return (ch, thr, torch.as_tensor(p, device=card),
            torch.as_tensor(ds, device=card), ranks)


# (band planes, output planes, operator choices, offset in floats): two
# planes each with its operator, the wrapped dual form (one band plane,
# both operators) and a base 4 bytes off 8-byte alignment
LOWRANK_FORMS = {"single": (2, 2, [0, 1], 0), "wrapped": (1, 2, [0, 1], 0),
                 "misaligned": (1, 1, [1], 1)}


@pytest.mark.parametrize("form", sorted(LOWRANK_FORMS))
@pytest.mark.parametrize("level", [0, 1])
def test_card_notch_delta_lowrank_fixed_order(card, level, form):
    """The exact-rank notch tail at the fused plane's levels 0 (9002
    columns) and 1 (4503): bit-equal to its term-by-term k-order witness,
    within f32 rounding of its plain twin, two launches."""
    B, n_out, sels, offset = LOWRANK_FORMS[form]
    ch, thr, p, ds, ranks = _lowrank_inputs(card, level, B, n_out,
                                            300 + level, offset)
    sel = torch.tensor(sels, dtype=torch.int32, device=card)
    h, w = ch.shape[1:]
    vp, vs = tn.plan_notch_lowrank(n_out, h, w, p.shape[1],
                                   ch.data_ptr() % 8, p.data_ptr() % 8,
                                   ds.data_ptr() % 8)
    assert vp == (1 if offset or w % 2 else 2) and vs == (1 if w % 2 else 2)
    tops.reset_launches()
    got = tn.notch_delta_lowrank(ch, thr, sel, p, ds, ranks)
    assert tn.notch_delta_lowrank.launches == 2
    assert tn.row_median_masked.launches == 1
    assert torch.equal(got, _lowrank_witness(ch, thr, sel, p, ds, ranks))
    want = tn.notch_delta_lowrank_plain(ch, thr, sel, p, ds, ranks)
    _close(got, want)
    assert torch.all(got[0] == 0.0)  # thr 0: every coefficient a stripe


def test_card_notch_delta_lowrank_plane_alone_as_in_a_batch(card):
    """A plane's delta does not depend on the planes beside it: plane 2 of
    a 4-plane batch (one cells plane, three no-cells) alone, bit for
    bit."""
    ch, thr, p, ds, ranks = _lowrank_inputs(card, 1, 4, 4, 310)
    sel = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=card)
    batch = tn.notch_delta_lowrank(ch, thr, sel, p, ds, ranks)
    alone = tn.notch_delta_lowrank(ch[2:3].contiguous(), thr[2:3],
                                   sel[2:3], p, ds, ranks)
    assert torch.equal(alone[0], batch[2])


@pytest.mark.parametrize("hw", [(1600, 2000), (16384, 18000)],
                         ids=["tile", "stitched"])
def test_card_notch_route_launches(card, hw):
    """The plan's route on the card: one plane of the tile plan runs the
    chirp-z notch at its 3 widest levels and the dense notch at the other
    5, one fused plane the factors at its 11 levels (two launches each)
    and neither of the others; ``plan.notch_lowrank_levels`` and
    ``plan.notch_fft_levels`` count the routed levels."""
    from aind_smartspim_destripe_torch.runtime import tracing

    plan = tf.build_plan(*hw, tf.FilterConfig(sigma=64, max_threshold=3),
                         tf.FilterConfig(sigma=128, max_threshold=12))
    names = ("plan.notch_lowrank_levels", "plan.notch_fft_levels")
    before = [tracing.counters().get(k, 0) for k in names]
    consts = tf.device_constants(plan, card)
    lowrank, fft = (tracing.counters()[k] - b for k, b in zip(names, before))
    routes = plan.notch_routes()
    assert (lowrank, fft) == (routes.count("lowrank"), routes.count("chirp"))
    assert (lowrank, fft) == ((0, 3) if hw == (1600, 2000) else (11, 0))
    x = torch.randint(200, 400, (1,) + hw, dtype=torch.int32,
                      device=card).to(torch.uint16)
    tops.reset_launches()
    tf.destripe_batch(plan, x, 2500.0, consts)
    torch.cuda.synchronize()
    n = plan.n_levels
    assert tn.notch_delta_lowrank.launches == 2 * lowrank
    assert tn.notch_delta_fft.launches == fft
    assert tn.notch_delta.launches == n - lowrank - fft
    assert tn.row_median_masked.launches == n


# --- the chirp-z notch tail (notch_delta_fft) -------------------------------

TILE_PLAN = ((1600, 2000), (64.0, 3.0), (128.0, 12.0))


def _chirp_inputs(card, level, B, n_out, seed):
    """A band of the tile plan's level ``level`` (B planes, h x w as the
    step has them), ``n_out`` thresholds with the production caps' spread
    (the first 0.0: every nonzero coefficient a stripe), alternating
    configurations (the dual form: the first B cells, the rest no-cells),
    the level's chirp-z tables and its dense bank on the card."""
    (hw, c, nc) = TILE_PLAN
    plan = tf.build_plan(*hw, tf.FilterConfig(sigma=c[0], max_threshold=c[1]),
                         tf.FilterConfig(sigma=nc[0], max_threshold=nc[1]))
    i = plan.n_levels - 1 - level
    (h, w), sigmas = plan.ladder[i], plan.notch_sigmas()[i]
    assert plan.notch_routes()[i] == "chirp"
    g = torch.Generator(device="cpu").manual_seed(seed)
    ch = (torch.randn((B, h, w), generator=g) * 0.3).to(card)
    thr = torch.linspace(0.2, 0.9, n_out, device=card)
    thr[0] = 0.0
    idx = torch.arange(n_out, device=card)
    sel = ((idx >= B) if n_out == 2 * B else (idx % 2 == 1)).to(torch.int32)
    rec = tf.device_constants(plan, card)["notch_cat"][i]
    cat = torch.as_tensor(np.ascontiguousarray(fft_notch.notch_cat(w, sigmas)),
                          device=card)
    return ch, thr, sel, rec, cat, sigmas


def _row_scaled_errors(got, truth, stripes):
    """The error against ``truth`` of each value off the stripes, over its
    row's largest |truth|: (max, RMS) over every such value."""
    scale = truth.abs().amax(-1, keepdim=True)
    keep = ~stripes & (scale > 0)
    e = ((got.double() - truth) / torch.where(scale > 0, scale, 1.0))[keep]
    return e.abs().max().item(), e.pow(2).mean().sqrt().item()


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_card_notch_delta_fft_against_float64(card, level, dual):
    """The chirp-z tail at the tile plan's levels 0 (802 x 1002), 1 (403 x
    503) and 2 (204 x 254), B = 64 (the dual form: 128 outputs), is no
    farther from the float64 delta on the same mask and inpainting than
    the dense tail on the same bands (max and RMS of the error over each
    row's largest value), within f32 rounding of its plain twin, two
    launches."""
    B = 64
    n_out = 2 * B if dual else B
    ch, thr, sel, rec, cat, sigmas = _chirp_inputs(card, level, B, n_out,
                                                   400 + level)
    w = ch.shape[-1]
    tops.reset_launches()
    got = tn.notch_delta_fft(ch, thr, sel, rec)
    torch.cuda.synchronize()
    assert tn.notch_delta_fft.launches == 1
    assert tn.row_median_masked.launches == 1
    dense = tn.notch_delta(ch, thr, sel, cat)
    c = ch.repeat(n_out // B, 1, 1)
    stripes = torch.sqrt(c * c) > thr[:, None, None]
    assert torch.all(got[stripes] == 0.0) and torch.all(got[0] == 0.0)
    med = tn.row_median_masked(ch, thr)
    inpainted = torch.where(stripes, med, c).double()
    ops = [torch.as_tensor(fft_notch.packed_notch_matrix(w, s).T,
                           device=card) for s in sigmas]
    truth = torch.empty_like(inpainted)
    for s in (0, 1):
        idx = (sel == s).nonzero().flatten()
        truth[idx] = inpainted[idx] @ ops[s] - c[idx].double()
    truth = torch.where(stripes, 0.0, truth)
    e_fft = _row_scaled_errors(got, truth, stripes)
    e_dense = _row_scaled_errors(dense, truth, stripes)
    assert e_fft[0] <= e_dense[0] and e_fft[1] <= e_dense[1], (e_fft,
                                                               e_dense)
    _close(got, tn.notch_delta_fft_plain(ch, thr, sel, rec),
           scale=ch.abs().max().item())


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("level", [0, 1])
def test_card_notch_delta_fft_plane_alone_as_in_a_batch(card, level, dual):
    """A plane's delta does not depend on the planes beside it: plane 5 of
    a 64-plane batch alone (B = 1; dual: its two outputs), bit for bit, at
    an even (802) and an odd (403) row count."""
    B = 64
    n_out = 2 * B if dual else B
    ch, thr, sel, rec, _, _ = _chirp_inputs(card, level, B, n_out, 410)
    batch = tn.notch_delta_fft(ch, thr, sel, rec)
    pick = [5, 5 + B] if dual else [5]
    alone = tn.notch_delta_fft(ch[5:6].contiguous(), thr[pick].contiguous(),
                               sel[pick].contiguous(), rec)
    assert torch.equal(alone, batch[pick])


def test_card_notch_delta_fft_refuses(card):
    """The wrapper raises for what the kernel does not take: three outputs
    per band plane, a band of another width than the tables'."""
    ch, thr, sel, rec, _, _ = _chirp_inputs(card, 2, 2, 2, 420)
    with pytest.raises(ValueError, match="1 or 2"):
        tn.notch_delta_fft(ch, thr.repeat(3), sel.repeat(3), rec)
    with pytest.raises(ValueError, match="shape"):
        tn.notch_delta_fft(ch[..., :-1].contiguous(), thr, sel, rec)
