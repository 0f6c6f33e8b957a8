"""
aind_smartspim_destripe_torch — the PyTorch / CUDA port of the SmartSPIM
destriping framework, for one NVIDIA H100.

It mirrors ``aind_smartspim_destripe_tpu`` (the JAX reference), and imports
nothing of it: the host code it shares (store IO, the blosc codec source,
provenance) is the port's own copy.

- ``ops``      — the numpy plan builders, the destripe step in torch, and
                 its CUDA kernels (``csrc/``: the banded DWT passes K1-K4,
                 the Otsu histogram, the row medians, the notch tail and
                 the dual-band blend) with their plain twins;
- ``runtime``  — the streaming host<->device pipeline and tracing;
- ``parallel`` — the mesh, the row-sharded route and multi-host runs
                 (``distributed``: tiles across processes over gloo);
- ``models``   — the BaSiC shading model;
- ``io``       — store IO (Zarr, OME-NGFF, TIFF) and the blosc-zstd codec;
- ``utils``    — logging, resource profiling, system information, the
                 SmartSPIM tree walk.

``zarr_destriper`` and ``run_capsule`` carry the production Zarr path;
``filtering`` the per-plane facade; ``destriper`` (with
``destriper_params``) the file-batch path; ``flatfield_estimation`` the
per-slide flat estimation; ``__main__`` the CLI (``capsule`` and
``batch``).
"""

__version__ = "0.1.0"
