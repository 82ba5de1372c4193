"""A small writer of Hugging Face checkpoint directories, for the examples
that build a hermetic model without transformers: config.json beside one
model.safetensors, or several shards and their model.safetensors.index.json.
models/hf.py's from_hf reads what it writes, and so does transformers."""

from __future__ import annotations

import json
import os

import torch

_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16"}


def write_safetensors(path, tensors: dict) -> int:
    """An 8-byte little-endian header length, the JSON header, the raw
    bytes of each tensor (CPU; bf16, fp16 or fp32) in order.  Returns the
    bytes written."""
    header, off, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    return 8 + len(head) + off


def write_hf_dir(path, state_dict: dict, config: dict, shards: int = 1) -> int:
    """config.json and the state dict as `shards` safetensors files (one:
    model.safetensors; more: model-0000i-of-0000n.safetensors and the
    index).  Returns the bytes of the weights written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    names = list(state_dict)
    if shards == 1:
        return write_safetensors(os.path.join(path, "model.safetensors"),
                                 state_dict)
    per = -(-len(names) // shards)
    files = {f"model-{i + 1:05d}-of-{shards:05d}.safetensors":
             names[i * per:(i + 1) * per] for i in range(shards)}
    nbytes = sum(write_safetensors(os.path.join(path, file),
                                   {k: state_dict[k] for k in keys})
                 for file, keys in files.items())
    total = sum(t.numel() * t.element_size() for t in state_dict.values())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": {k: file for file, keys in files.items()
                                  for k in keys}}, f)
    return nbytes
