"""Store IO of the port: the reference package's JAX-free image readers and
writers and its Zarr store, re-exported, and the blosc-zstd codec they
encode with (:mod:`.codec`)."""

from aind_smartspim_destripe_tpu.io.readers import imread
from aind_smartspim_destripe_tpu.io.writers import imsave
from aind_smartspim_destripe_tpu.io.zarr import group, open_zarr

from .codec import ensure_native_codec

__all__ = ["imread", "imsave", "group", "open_zarr", "ensure_native_codec"]
