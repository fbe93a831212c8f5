"""Functionals of the port (``paddle_tpu.nn.functional``): the subset the
training GPT runs, and ``sparse_attention``."""
from .activation import gelu  # noqa: F401
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        sparse_attention, would_use_block_sparse,
                        would_use_flash)
from .common import add, dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy, would_use_fused_xent  # noqa: F401
from .norm import layer_norm  # noqa: F401
