"""The torch package's destripe step against the JAX package on the CPU.

Otsu, the classifier, the inpainting median, the flat-field and wrap casts
and the pyramid mean are exact against the JAX package. ``destripe_batch``
is held against the JAX ``destripe_batch`` on the same seeded inputs at
96x128 B=4 (all levels dense) and 640x768 B=2 (the port takes level 0
through the K1-K4 twins), with both uint16 epilogues, and against the
float64 oracle tests/golden/numpy_ref.py.

The two packages sum in different orders (XLA's and torch's f32 matrix
products, and their log/exp), so a coefficient on a threshold can land on
the other side of it: an Otsu bin or a stripe-mask compare flips, and the
pixels that coefficient reconstructs move by more than 1 LSB. The gate
therefore allows a stated flip budget (pixels off by more than 1 LSB) and
holds every other pixel to PSNR >= 100 dB, as tests/test_halo_pallas.py
does across formulations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.ops import flatfield as jff  # noqa: E402
from aind_smartspim_destripe_tpu.ops import multiscale as jms  # noqa: E402
from aind_smartspim_destripe_tpu.ops import otsu as jo  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402
from aind_smartspim_destripe_torch.ops import flatfield as tff  # noqa: E402
from aind_smartspim_destripe_torch.ops import multiscale as tms  # noqa: E402
from aind_smartspim_destripe_torch.ops import otsu as to  # noqa: E402
from tests.golden import numpy_ref as G  # noqa: E402

CELLS = dict(wavelet="db3", level=None, sigma=64.0, max_threshold=3.0)
NO_CELLS = dict(wavelet="db3", level=None, sigma=128.0, max_threshold=12.0)
HIGH_INT = 2500.0
FLIP_BUDGET = 0.01  # share of pixels allowed > 1 LSB off (threshold flips)


def _batch(b, h, w, seed):
    """Striped light-sheet-like planes; odd planes bright with blobs (the
    cells branch of the classifier), even planes dim (no cells)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(b):
        img = 300.0 + 400 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
                                   / (2 * (h / 4) ** 2))
        img = img + rng.normal(size=(h, 1)) * 60 + rng.normal(size=(h, w)) * 15
        if i % 2:
            img = img + 2600
            for _ in range(20):
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                img += 6000 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
        out.append(img)
    return np.clip(np.stack(out), 0, 65535).astype(np.uint16)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(65535.0**2 / mse)


def _gate_vs_jax(got, want, psnr_min=100.0):
    """Flip budget plus PSNR over the pixels that did not flip; returns
    (share of flipped pixels, PSNR)."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    flips = d > 1.0
    share = float(flips.mean())
    assert share <= FLIP_BUDGET, f"{share:.2%} of pixels flipped"
    psnr = _psnr(got[~flips], want[~flips])
    assert psnr >= psnr_min, f"PSNR {psnr:.1f} dB"
    return share, psnr


# ---------------------------------------------------------------------------
# Stats and epilogues: exact
# ---------------------------------------------------------------------------


def test_otsu_batch_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.abs(rng.normal(0, 1, (3, 40, 80))),
                        np.abs(rng.normal(8, 2, (3, 10, 80)))], 1)
    x = x.astype(np.float32)
    x[2] = 5.0  # a constant plane returns the constant
    want = np.asarray(jo.threshold_otsu_batch(jnp.asarray(x), pallas=False))
    got = to.threshold_otsu_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    ch = (rng.normal(size=(3, 50, 66)) * 0.4).astype(np.float32)
    want_sq = np.asarray(jo.threshold_otsu_batch(jnp.asarray(ch * ch),
                                                 pallas=False))
    t = torch.from_numpy(ch)
    np.testing.assert_array_equal(
        to.threshold_otsu_batch(t, square=True).numpy(), want_sq)
    a = t.abs()
    rng_ = (a.amin(dim=(1, 2)), a.amax(dim=(1, 2)))
    np.testing.assert_array_equal(
        to.threshold_otsu_batch(t, square=True, abs_range=rng_).numpy(),
        want_sq)
    assert float(to.threshold_otsu(torch.from_numpy(x[0]))) == float(
        jo.threshold_otsu(jnp.asarray(x[0])))


def test_otsu_scan_is_the_cpu_cumsum():
    """The Otsu tail scans in float64 and rounds per element, which is what
    torch's CPU float32 cumsum does, bit for bit: the CPU path is unchanged
    by it, and the card's scan no longer depends on the batch's shape."""
    from aind_smartspim_destripe_torch.ops.cuda_hist import _cumsum

    rng = np.random.default_rng(12)
    counts = rng.integers(0, 200_000, (5, 256)).astype(np.float32)
    centers = (rng.random((5, 256)) * 1e3).astype(np.float32)
    x = torch.from_numpy(counts * centers)
    got = _cumsum(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.cumsum(x, dim=1))
    assert torch.equal(_cumsum(x[2:3]), got[2:3])


def test_histogram_and_otsu_from_counts_exact():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 30, 70)) ** 2).astype(np.float32)
    counts, centers = to.histogram_fixed_bins(torch.from_numpy(x[0]))
    jc, jcen = jo.histogram_fixed_bins(jnp.asarray(x[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jcen))
    lo, hi = x.min((1, 2)), x.max((1, 2))
    cnt = np.stack([np.histogram(p, 256, (a, b))[0] for p, a, b in
                    zip(x, lo, hi)]).astype(np.float32)
    np.testing.assert_array_equal(
        to.otsu_from_counts(torch.from_numpy(cnt), torch.from_numpy(lo),
                            torch.from_numpy(hi)).numpy(),
        np.asarray(jo.otsu_from_counts(jnp.asarray(cnt), jnp.asarray(lo),
                                       jnp.asarray(hi))))


def test_classifier_exact():
    x = _batch(4, 64, 80, seed=3)
    x[2] = 2400  # flat plane just under the high-intensity gate
    x[3, :, :40] = 0  # half-empty bright plane
    want = np.asarray(jf.classify_planes(jnp.asarray(x), HIGH_INT))
    got = tf.classify_planes(torch.from_numpy(x), HIGH_INT).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [False, True, False, True]
    sums = [np.float32(v) for v in (10.0, 0.0, 30000.0, 0.0)]
    assert bool(tf.classify_from_sums(
        *(torch.tensor([v]) for v in sums), HIGH_INT)) == bool(
        jf.classify_from_sums(*(jnp.asarray([v]) for v in sums), HIGH_INT)[0])


@pytest.mark.parametrize("w", [65, 66])
def test_row_median_exact(w):
    x = np.random.default_rng(w).normal(size=(2, 9, w)).astype(np.float32)
    x[:, :, ::3] = 0.0  # ties, as the zeroed stripes give
    np.testing.assert_array_equal(
        tn.row_median(torch.from_numpy(x)).numpy(),
        np.asarray(jf._row_median(jnp.asarray(x), pallas=False)))


def test_flatfield_and_wrap_exact():
    rng = np.random.default_rng(5)
    y = rng.uniform(-100, 140000, (2, 40, 50)).astype(np.float32)
    flat = (1.0 + rng.random((40, 50))).astype(np.float32)
    dark = rng.uniform(0, 50, (45, 60)).astype(np.float32)  # cropped
    np.testing.assert_array_equal(
        tff.flatfield_correction(torch.from_numpy(y), torch.from_numpy(flat),
                                 torch.from_numpy(dark)).numpy(),
        np.asarray(jff.flatfield_correction(y, flat, dark)))
    base = np.array([3.0, 7.0], np.float32)
    np.testing.assert_array_equal(
        tff.flatfield_correction(torch.from_numpy(y), torch.from_numpy(flat),
                                 torch.from_numpy(dark), base).numpy(),
        np.asarray(jff.flatfield_correction(y, flat, dark, base)))
    np.testing.assert_array_equal(
        tf.wrap_cast(torch.from_numpy(y)).numpy(),
        np.asarray(jf.wrap_cast(jnp.asarray(y))))
    flats = [rng.integers(100, 4000, (8, 9)).astype(np.uint16)
             for _ in range(2)]
    np.testing.assert_array_equal(tff.normalize_image(flats).numpy(),
                                  np.asarray(jff.normalize_image(flats)))
    cfg = {"471320": {"461360": 1}}
    assert tff.get_hemisphere_flatfield("471320_461360", cfg, ["a", "b"]) == "b"
    with pytest.raises(KeyError):
        tff.get_hemisphere_flatfield("1_2", cfg, ["a", "b"])


def test_windowed_mean_exact():
    x = np.random.default_rng(2).integers(0, 65535, (1, 1, 9, 33, 20),
                                          np.uint16)
    got = tms.windowed_mean(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, jms.windowed_mean_np(x))
    np.testing.assert_array_equal(got, np.asarray(jms.windowed_mean(x)))
    from aind_smartspim_destripe_torch.zarr_destriper import compute_pyramid

    levels = compute_pyramid(x, 3, (2, 2, 2), device="cpu")
    assert len(levels) == 3
    np.testing.assert_array_equal(levels[1], got)
    np.testing.assert_array_equal(levels[2], jms.windowed_mean_np(got))


def test_normalize_flat_dark():
    flat, dark = tf.normalize_flat_dark(4, 6, np.full((1, 6), 2.0),
                                        np.zeros((5, 7)), "cpu")
    assert flat.shape == dark.shape == (4, 6) and flat.is_contiguous()
    with pytest.raises(ValueError, match="together"):
        tf.normalize_flat_dark(4, 6, np.ones((4, 6)), None, "cpu")
    with pytest.raises(ValueError, match="broadcast"):
        tf.normalize_flat_dark(4, 6, np.ones((3, 6)), np.zeros((4, 6)), "cpu")


# ---------------------------------------------------------------------------
# destripe_batch against JAX and the float64 oracle
# ---------------------------------------------------------------------------


def _plans(h, w):
    return (jf.build_plan(h, w, jf.FilterConfig(**CELLS),
                          jf.FilterConfig(**NO_CELLS)),
            tf.build_plan(h, w, tf.FilterConfig(**CELLS),
                          tf.FilterConfig(**NO_CELLS)))


# (geometry, batch, epilogue). Measured against JAX on this data, as flip
# share / PSNR of the other pixels: 96x128 flat 0 / 126.5 dB, wrap 0 /
# 126.4 dB; 640x768 flat 5.3e-5 / 128.3 dB, wrap 5.3e-5 / 127.5 dB (over
# all pixels 114.2 and 113.2 dB). Against the oracle, per plane: 96x128
# >= 122.8 dB, 640x768 >= 110.1 dB.
CASES = [((96, 128), 4, "flat"), ((96, 128), 4, "wrap"),
         ((640, 768), 2, "flat"), ((640, 768), 2, "wrap")]


@pytest.fixture(scope="module")
def runs():
    """Both packages' outputs per case, computed once."""
    out = {}
    for (h, w), b, epi in CASES:
        jp, tp = _plans(h, w)
        x = _batch(b, h, w, seed=h)
        rng = np.random.default_rng(w)
        flat = (1.0 + 0.25 * rng.random((h, w))).astype(np.float32)
        dark = np.full((h, w), 3.0, np.float32)
        if epi == "flat":
            kw_j = dict(flat=jnp.asarray(flat), dark=jnp.asarray(dark))
            kw_t = dict(flat=torch.from_numpy(flat),
                        dark=torch.from_numpy(dark))
        else:
            kw_j = kw_t = dict(wrap=True)
        want = np.asarray(jax.jit(
            lambda im: jf.destripe_batch(jp, im, HIGH_INT, jp.constants(),
                                         **kw_j))(jnp.asarray(x)))
        got = tf.destripe_batch(tp, torch.from_numpy(x), HIGH_INT,
                                **kw_t).numpy()
        out[((h, w), b, epi)] = (x, flat, dark, got, want)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[2]}")
def test_destripe_batch_matches_jax(runs, case):
    (h, w), b, epi = case
    _, _, _, got, want = runs[case]
    assert got.dtype == want.dtype == np.uint16 and got.shape == (b, h, w)
    _gate_vs_jax(got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[2]}")
def test_destripe_batch_matches_oracle(runs, case):
    """>= 60 dB per plane against the float64 numpy oracle."""
    x, flat, dark, got, _ = runs[case]
    for p, plane in enumerate(x):
        ref = G.filter_stripes_ref(plane.astype(np.float64), NO_CELLS, CELLS,
                                   HIGH_INT)
        if case[2] == "flat":
            ref = G.flatfield_correction_ref(ref, flat, dark)
        else:
            ref = np.mod(np.trunc(ref).astype(np.int64), 65536)
        assert _psnr(got[p], ref) >= 60.0, p


def test_band_path_taken_at_640x768():
    for hw, want in (((640, 768), {"band0"}), ((96, 128), set())):
        _, tp = _plans(*hw)
        consts = tf.device_constants(tp, "cpu")
        assert {k for k in consts if k.startswith("band")} == want


def test_float_output_and_single_config_entry_point():
    x = _batch(2, 96, 128, seed=9)
    jp, tp = _plans(96, 128)
    want = np.asarray(jf.destripe_batch(jp, jnp.asarray(x), HIGH_INT,
                                        jp.constants()))
    got = tf.destripe_batch(tp, torch.from_numpy(x), HIGH_INT).numpy()
    assert got.dtype == np.float32
    _gate_vs_jax(got, want)
    plane = x[0].astype(np.float32)
    a = tf.log_space_fft_filtering(plane, level=None, sigma=64,
                                   max_threshold=3, device="cpu")
    b = jf.log_space_fft_filtering(plane, level=None, sigma=64,
                                   max_threshold=3)
    assert a.shape == plane.shape
    _gate_vs_jax(a, np.asarray(b))

