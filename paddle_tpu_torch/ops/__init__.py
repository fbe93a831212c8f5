"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (see ``_build`` for how they are built)."""
from .ragged_paged_attention import (  # noqa: F401
    ragged_paged_attention, ragged_paged_attention_chunked,
    ragged_paged_attention_chunked_torch, ragged_paged_attention_torch)
from .flash_attention import (flash_dkv, flash_dq,  # noqa: F401
                              flash_fwd)
from .softmax_xent import (fused_softmax_cross_entropy,  # noqa: F401
                           xent_bwd, xent_fwd)
from .block_sparse_attention import (bsa_dkv, bsa_dq,  # noqa: F401
                                     bsa_fwd, local_global_mask)
from .layer_norm import fused_layer_norm, ln_fwd  # noqa: F401
