"""Store IO of the port: image readers and writers, the Zarr v2 store, the
OME-NGFF metadata writer and the blosc-zstd chunk codec, the port's own
copies of the JAX package's JAX-free ``io`` modules, with the native codec
built by :mod:`.codec`."""

from .codec import ensure_native_codec
from .readers import imread
from .writers import imsave
from .zarr import group, open_zarr

__all__ = ["imread", "imsave", "group", "open_zarr", "ensure_native_codec"]
