from .convert import gpt_params_from_jax  # noqa: F401
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  gpt2_medium, gpt2_small, gpt3_1p3b, gpt_tiny)
