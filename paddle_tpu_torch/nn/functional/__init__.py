"""Functionals of the port (``paddle_tpu.nn.functional``): the subset the
training GPT runs."""
from .activation import gelu  # noqa: F401
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        would_use_flash)
from .common import add, dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy, would_use_fused_xent  # noqa: F401
from .norm import layer_norm  # noqa: F401
