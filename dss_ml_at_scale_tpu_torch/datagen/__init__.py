"""Synthetic data generators of the port: images for the classifier, the
Markov token source for the LM."""

from .images import grating_jpeg, write_image_delta
from .tokens import TokenStreamConfig, entropy_floor, token_batches, transition_matrix

__all__ = ["TokenStreamConfig", "entropy_floor", "grating_jpeg", "token_batches",
           "transition_matrix", "write_image_delta"]
