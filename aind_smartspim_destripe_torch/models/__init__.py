"""Models: the BaSiC shading model."""

from .basic import BaSiC  # noqa: F401
