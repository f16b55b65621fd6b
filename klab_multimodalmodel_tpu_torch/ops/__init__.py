"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions."""

from .fused_attention import (draw_seed, dropout_keep_mask,  # noqa: F401
                              philox4x32_10,
                              SwinAttentionFn, swin_attention,
                              swin_attention_plain, swin_attention_reference,
                              t5_attention, t5_attention_bwd,
                              t5_attention_bwd_plain, t5_attention_fwd,
                              t5_attention_plain)
