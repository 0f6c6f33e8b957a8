"""Numeric kernels: plan builders, the destripe step, the dual-band mode,
and the CUDA kernels with their plain twins (``cuda_band``: the banded DWT
passes K1-K4, ``cuda_hist``: the Otsu histogram, ``cuda_notch``: row
medians and the notch tail, ``cuda_blend``: the dual-band blend,
``cuda_dense``: the dense levels' products), built by ``cuda_build``."""


def kernels():
    """Every kernel wrapper of the package; each counts the launches of its
    kernel in ``.launches``."""
    from . import cuda_band, cuda_blend, cuda_dense, cuda_hist, cuda_notch

    return (cuda_band.KERNELS + cuda_hist.KERNELS + cuda_notch.KERNELS
            + cuda_blend.KERNELS + cuda_dense.KERNELS)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in kernels():
        k.launches = 0
