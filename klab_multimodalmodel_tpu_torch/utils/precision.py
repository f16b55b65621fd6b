"""Mixed-precision policy: parameters and optimizer state in fp32, matrix
products and activations in the compute dtype (bf16 by default), softmax and
norm statistics in fp32."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_policy(compute_dtype: str = "bfloat16",
               param_dtype: str = "float32") -> Policy:
    return Policy(param_dtype=_DTYPES[param_dtype],
                  compute_dtype=_DTYPES[compute_dtype])
