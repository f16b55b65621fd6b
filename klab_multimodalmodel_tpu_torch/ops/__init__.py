"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions."""

from .fused_attention import (swin_attention, swin_attention_plain,  # noqa: F401
                              t5_attention, t5_attention_plain)
