"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card: entry points run on CUDA unless the caller
    asks for the CPU. Asking for CUDA where there is none raises; nothing
    carries on quietly on the CPU.

    Also pins fp32 numerics. The reference computes captioning in full
    fp32, and the card would otherwise run the patch-embed convolution in
    TF32 (cuDNN's default), so TF32 is turned off for matmuls and
    convolutions alike.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device
