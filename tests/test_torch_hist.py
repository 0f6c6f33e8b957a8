"""The Otsu histogram of the torch package (ops/cuda_hist.py) on the CPU.

The launch geometry (``hist_blocks``: blocks per plane from the planes,
their values and the card's SM count), the wrapper's refusals, and the
plain twin against the JAX package's Pallas kernel (ops/pallas_hist.py) in
interpret mode on an odd plane length and on one plane with a row bound.
Counts are exact. The Hopper kernel itself is held against the twin on the
card by tests/test_torch_card.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import pallas_hist as ph  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_hist as th  # noqa: E402


@pytest.mark.parametrize("B,n_valid,sms,want", [
    (1, 4097 * 9002, 132, 1056),  # a level-0 halo shard: fills the card
    (1, 2049 * 4503, 132, 1056),  # a level-1 halo shard
    (64, 802 * 1002, 132, 17),  # the plane step's level 0: 1088 blocks
    (64, 1600 * 2000, 132, 49),  # the raw uint16 planes: 256 per thread
    (64, 403 * 503, 132, 17),
    (64, 204 * 254, 132, 7),  # few values: 32 per thread at least
    (64, 11 * 12, 132, 1),
    (1, 0, 132, 1),
    (3, 10**9, 1, 15259),
    (1, 2049 * 4503, 114, 912),  # another SM count
])
def test_hist_blocks(B, n_valid, sms, want):
    """Blocks per plane: about 256 values per thread of 256, and at least 8
    blocks on every SM over the B planes while a thread keeps 32 values; a
    plane gets 1 at least."""
    got = th.hist_blocks(B, n_valid, sms)
    assert got == want
    assert got * 256 * 256 >= n_valid
    assert got == 1 or got * B >= min(8 * sms, B * -(-n_valid // (256 * 32)))


@pytest.mark.parametrize("B,n_valid,sms", [(0, 10, 132), (1, 10, 0),
                                           (1, -1, 132)])
def test_hist_blocks_refuses(B, n_valid, sms):
    with pytest.raises(ValueError, match="hist_blocks"):
        th.hist_blocks(B, n_valid, sms)


def _jax(x, lo, span, square, row_bound=None):
    rb = None if row_bound is None else jnp.asarray([row_bound], jnp.int32)
    return np.asarray(ph.histogram256_batch(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(span), square=square,
        row_bound=rb, interpret=True))


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_histogram_plain_odd_plane_length(dtype):
    """An odd plane length (3 x 37 x 203 = 7511 values per plane, as level
    1's 403 x 503), values outside [lo, lo + span] on both sides (the end
    bins take them), uint16 0 and 65535."""
    rng = np.random.default_rng(203)
    shape = (3, 37, 203)
    if dtype == np.uint16:
        x = rng.integers(0, 65536, shape).astype(np.uint16)
        x[:, 0, :2] = [0, 65535]
        lo = np.array([1000.0, 0.0, 30000.0], np.float32)
        span = np.array([30000.0, 65535.0, 100.0], np.float32)
    else:
        x = (rng.normal(size=shape) * 3.0).astype(np.float32)
        lo = np.array([-2.0, 0.5, 0.0], np.float32)
        span = np.array([4.0, 3.0, 1e-3], np.float32)
    for square in (False, True):
        got = th.histogram256_batch(torch.from_numpy(x), torch.from_numpy(lo),
                                    torch.from_numpy(span), square=square)
        np.testing.assert_array_equal(got.numpy(),
                                      _jax(x, lo, span, square))
        assert np.all(got.numpy().sum(1) == np.prod(shape[1:]))


@pytest.mark.parametrize("row_bound", [0, 1, 57, 64])
def test_histogram_plain_one_plane_row_bound(row_bound):
    """One plane (a halo shard) with a row bound: the twin counts the
    first row_bound rows only, as the JAX kernel's dynamic bound does."""
    rng = np.random.default_rng(row_bound)
    x = (rng.normal(size=(1, 64, 131)) * 2.0).astype(np.float32)
    a = np.abs(x[:, :max(row_bound, 1)])
    lo = (a.min(axis=(1, 2)) ** 2).astype(np.float32)
    span = (a.max(axis=(1, 2)) ** 2 - lo).astype(np.float32)
    span = np.where(span > 0, span, 1.0).astype(np.float32)
    got = th.histogram256_batch(torch.from_numpy(x), torch.from_numpy(lo),
                                torch.from_numpy(span), square=True,
                                row_bound=row_bound)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax(x, lo, span, True, row_bound))
    assert got.numpy().sum() == row_bound * 131
