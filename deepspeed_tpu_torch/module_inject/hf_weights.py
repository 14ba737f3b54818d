"""HF weight files without ``safetensors`` or ``transformers``.

The safetensors format, read and written here from its definition: an
8-byte little-endian header length N, N bytes of JSON mapping each tensor
name to its ``dtype`` (``"BF16"``, ``"F32"``, ...), ``shape`` and
``data_offsets`` ``[begin, end)`` into the byte buffer that follows (plus
an optional ``"__metadata__"`` of strings), then that buffer.  A read
maps the file copy-on-write (``np.memmap`` mode ``"c"``) and returns
tensors that are views of it, in the file's dtype: nothing is read until
a leaf is used, and pages read for one leaf are the kernel's page cache,
so a 7B-width directory is never held twice in process memory.

``pytorch_model.bin`` goes through ``torch.load(weights_only=True)``,
memory-mapped when the file is in the zip format ``torch.save`` writes.

:func:`load_hf_state_dict` reads a ``save_pretrained`` directory: one
``model.safetensors`` or ``pytorch_model.bin``, or the shards named by
``model.safetensors.index.json`` / ``pytorch_model.bin.index.json``
(the JAX ``load_hf_state_dict``, ``module_inject/replace_module.py:18-59``).
:func:`save_hf_dir` writes such a directory (the tests' and
``chip_smoke.py``'s HF checkpoints, made without ``transformers``).
"""

import json
import os
import struct

import numpy as np
import torch

# safetensors dtype tag <-> torch dtype
ST_DTYPES = {"BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
             "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
             "F16": torch.float16, "BF16": torch.bfloat16,
             "F32": torch.float32, "F64": torch.float64,
             "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}
ST_TAGS = {v: k for k, v in ST_DTYPES.items()}
# the numpy type a buffer is viewed as before torch re-views it; the
# types numpy lacks (bf16, fp8) travel as their bits
_NP_VIEW = {torch.bool: np.bool_, torch.uint8: np.uint8,
            torch.int8: np.int8, torch.int16: np.int16,
            torch.int32: np.int32, torch.int64: np.int64,
            torch.float16: np.float16, torch.bfloat16: np.int16,
            torch.float32: np.float32, torch.float64: np.float64,
            torch.float8_e4m3fn: np.uint8, torch.float8_e5m2: np.uint8}

SAFETENSORS = "model.safetensors"
PT_BIN = "pytorch_model.bin"


def read_safetensors_header(path):
    """(header dict without ``__metadata__``, metadata, data start)."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def read_safetensors(path):
    """``{name: tensor}``, each a view of the file mapped copy-on-write,
    in the file's dtype."""
    header, _, start = read_safetensors_header(path)
    if not header:
        return {}
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, info in header.items():
        dtype = ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']!r}, not one of {list(ST_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = buf[start + begin:start + end]
        n = int(np.prod(shape)) if shape else 1
        if raw.size != n * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name} spans {raw.size} bytes "
                             f"for shape {shape} {info['dtype']}")
        arr = raw.view(_NP_VIEW[dtype]).reshape(shape)
        t = torch.from_numpy(arr)
        out[name] = t.view(dtype) if t.dtype != dtype else t
    return out


def _tensor_bytes(t):
    """The raw bytes of a CPU tensor as a uint8 numpy array."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2,
                   torch.float16):
        t = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
    return t.numpy().reshape(-1).view(np.uint8)


def write_safetensors(path, tensors, metadata=None):
    """Write ``{name: tensor}`` in the safetensors format, one tensor's
    bytes at a time (header padded to 8 bytes, data without gaps, wider
    elements first so every tensor starts aligned to its element).
    ``metadata`` defaults to ``{"format": "pt"}``, which ``transformers``
    asks of a PyTorch checkpoint."""
    tensors = dict(sorted(tensors.items(),
                          key=lambda kv: -kv[1].element_size()))
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = dict(metadata or {"format": "pt"})
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(_tensor_bytes(t).tobytes())
    os.replace(tmp, path)


def read_torch_bin(path):
    """``{name: tensor}`` of a ``pytorch_model.bin`` (weights only),
    memory-mapped when the file is in the zip format."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
    except RuntimeError:          # the legacy (non-zip) format
        return torch.load(path, map_location="cpu", weights_only=True)


def _read_file(path):
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return read_torch_bin(path)


def load_hf_state_dict(path):
    """A ``save_pretrained`` directory's weights, ``{name: tensor}`` in
    the files' dtypes (safetensors preferred over ``.bin``, sharded or
    not)."""
    for index in (SAFETENSORS + ".index.json", PT_BIN + ".index.json"):
        full = os.path.join(path, index)
        if os.path.exists(full):
            with open(full) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            out = {}
            for fn in files:
                out.update(_read_file(os.path.join(path, fn)))
            return out
    for name in (SAFETENSORS, PT_BIN):
        full = os.path.join(path, name)
        if os.path.exists(full):
            return _read_file(full)
    raise FileNotFoundError(f"no model weights found under {path}")


def save_hf_dir(path, config, state_dict, fmt="safetensors", shards=1):
    """Write a ``save_pretrained``-layout directory: ``config.json`` (the
    dict ``config``) and ``state_dict`` as ``model.safetensors`` or
    ``pytorch_model.bin`` (``fmt="bin"``), split over ``shards`` files of
    about equal bytes with an ``*.index.json`` when ``shards > 1``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)
    base = SAFETENSORS if fmt == "safetensors" else PT_BIN
    stem, ext = base.rsplit(".", 1)
    names = list(state_dict)
    total = sum(t.numel() * t.element_size() for t in state_dict.values())
    groups, size = [[]], 0
    for name in names:
        t = state_dict[name]
        if size >= total * len(groups) / shards and len(groups) < shards:
            groups.append([])
        groups[-1].append(name)
        size += t.numel() * t.element_size()
    weight_map = {}
    for i, group in enumerate(groups):
        fn = base if shards == 1 else \
            f"{stem}-{i + 1:05d}-of-{len(groups):05d}.{ext}"
        part = {n: state_dict[n] for n in group}
        if fmt == "safetensors":
            write_safetensors(os.path.join(path, fn), part)
        else:
            torch.save({n: t.detach().cpu().contiguous()
                        for n, t in part.items()}, os.path.join(path, fn))
        weight_map.update(dict.fromkeys(group, fn))
    if shards > 1:
        with open(os.path.join(path, base + ".index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
    return path
