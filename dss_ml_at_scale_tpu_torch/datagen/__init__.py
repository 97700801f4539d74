"""Synthetic data generators of the port (images for the training slice)."""

from .images import grating_jpeg, write_image_delta

__all__ = ["grating_jpeg", "write_image_delta"]
