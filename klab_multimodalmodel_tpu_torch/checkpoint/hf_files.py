"""Read a HuggingFace model directory's weights with nothing beyond PyTorch:
``model.safetensors`` through the port's own reader (no ``safetensors``
package), or ``pytorch_model.bin`` through ``torch.load``.

The safetensors layout: a little-endian u64 header length N, N bytes of
JSON header mapping each tensor's name to its ``dtype``, ``shape`` and
``data_offsets`` (begin, end; relative to the byte after the header), an
optional ``__metadata__`` entry, then the tensors' bytes, little-endian.
"""

from __future__ import annotations

import json
import os
import struct

import torch

# The dtypes of HF's T5 and SwinV2 checkpoints: weights in F32, F16 or
# BF16, and the I64 index tables of older SwinV2 files.
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, in its stored
    dtype."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, entry in header.items():
            if name == "__metadata__":
                continue
            dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name}: dtype {entry['dtype']} "
                                 "is not supported")
            begin, end = entry["data_offsets"]
            shape = tuple(entry["shape"])
            if end == begin:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            buf = bytearray(end - begin)
            f.seek(base + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: {name}: the file ends early")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
    return out


def load_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """A HF model directory's state dict: ``model.safetensors`` if there is
    one, else ``pytorch_model.bin``."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin in {model_dir}")
