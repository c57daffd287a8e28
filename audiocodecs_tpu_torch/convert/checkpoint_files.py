"""Reading upstream checkpoint files without the packages that wrote them.

The port's convert and inspect tools read three kinds of file, with
``torch``, ``json`` and the standard library alone:

* an HF model directory (``save_pretrained``'s): ``config.json`` and the
  weights in ``model.safetensors`` or ``pytorch_model.bin``;
* a safetensors file: an 8-byte little-endian header length, that many
  bytes of JSON (each tensor's ``dtype``, ``shape`` and ``data_offsets``
  into the data that follows), then the raw tensors;
* a vendor file that ``torch.load(…, weights_only=True)`` reads: a state
  dict, a state dict under ``"state_dict"``, or a dict of state dicts
  (BigCodec's ``{"CodecEnc", "generator"}``).
"""

from __future__ import annotations

import json
import os
import struct

import torch

__all__ = ["read_safetensors", "read_hf_directory", "load_checkpoint"]

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}


def read_safetensors(path: str) -> dict:
    """A safetensors file → ``{name: CPU tensor}`` (copies, not views of
    the file)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=(end - begin) // size,
                             offset=begin) if end > begin else torch.empty(
                                 0, dtype=dtype)
        out[name] = t.reshape(info["shape"]).clone()
    return out


def read_hf_directory(path: str) -> tuple[dict, dict]:
    """An HF model directory → (``config.json`` as a dict, the state
    dict), from ``model.safetensors`` or else ``pytorch_model.bin``."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return config, read_safetensors(st)
    return config, torch.load(os.path.join(path, "pytorch_model.bin"),
                              map_location="cpu", weights_only=True)


def load_checkpoint(path: str) -> dict:
    """A checkpoint file or HF directory → its state dict (or BigCodec's
    dict of two), unwrapping a ``"state_dict"`` entry."""
    if os.path.isdir(path):
        return read_hf_directory(path)[1]
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a dict checkpoint")
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return obj
