"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The port lives beside the JAX package and mirrors its module paths, so
``paddle_tpu_torch.serving.engine`` is the counterpart of
``paddle_tpu.serving.engine``. It imports ``torch`` and never ``jax``, and
nothing of ``paddle_tpu``: what it needs from there it keeps as its own
copy.

What is ported so far is single-card serving (``paddle_tpu_torch.serving``):
continuous batching over a paged KV cache, chunked prefill, a radix prefix
cache and on-device sampling, with the segmented ragged paged attention as
a hand-written CUDA kernel for Hopper (``paddle_tpu_torch.ops``); and
single-card training: the GPT of ``paddle_tpu_torch.text.models``, AdamW
and ``paddle_tpu_torch.jit.TrainStepper`` with O2 mixed precision, with
flash attention forward and backward as hand-written CUDA kernels.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); without a card they raise rather than fall back.
"""

__version__ = "0.1.0"
