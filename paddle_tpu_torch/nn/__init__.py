"""Neural-network layers and functionals of the port (``paddle_tpu.nn``):
the subset the training GPT runs."""
from . import functional  # noqa: F401
from .layer import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
