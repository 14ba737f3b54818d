"""Llama-family causal transformer (RMSNorm, RoPE, SwiGLU, GQA) in
PyTorch — counterpart of ``deepspeed_tpu/models/llama.py``.

``forward(ids, positions=None, cache=None)`` returns logits, or
``(logits, cache)`` with a cache.  Five branches are ported: no cache
(full causal forward, through the flash kernels or the plain attention
as ``cfg.attn_impl`` says), the dense cache of ``generate()``, and the paged
cache's chunked prefill (``"slot"`` in the cache), speculative verify
(``"widths"``: K+1 teacher-forced columns per slot) and continuous-batch
decode (``"active"``).  Sequence-parallel prefill and LoRA adapters
(ROADMAP.md Queue A10) wait.

Caches are ``models/kv_cache.py``'s (updated in place; its attention
branches and cache constructors serve this model and ``models/gpt2.py``).

Every projection is a ``QDense``: float, or weight-only int8 after
``ops/quant/quantizer.quantize_tree`` (the engine's ``quantize=``).
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.kv_cache import (  # noqa: F401
    dense_cache_attention, init_kv_cache, init_paged_kv_cache,
    paged_cache_attention)
from deepspeed_tpu_torch.ops.attention.decode import _repeat_kv
from deepspeed_tpu_torch.ops.attention.flash import (flash_attention,
                                                     resolve_attn_impl)
from deepspeed_tpu_torch.ops.attention.reference import (apply_rotary_emb,
                                                         mha_reference)
from deepspeed_tpu_torch.ops.quant.qdense import QDense
from deepspeed_tpu_torch.ops.quant.quantizer import QTensor


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32            # < num_heads => GQA
    intermediate_size: int = 11008
    max_seq_len: int = 4096
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    # no-cache attention: "auto" (flash on a CUDA tensor, reference on a
    # CPU one) | "reference" | "flash" (models/llama.py:235-241)
    attn_impl: str = "auto"
    # the head reads ``embed_tokens.weight`` (no ``lm_head``), as the JAX
    # model's ``tie_embeddings`` (models/llama.py:43, :369)
    tie_embeddings: bool = False

    def __post_init__(self):
        resolve_attn_impl(self.attn_impl, torch.device("cpu"))

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


class RMSNorm(nn.Module):
    """fp32 statistics, fp32 ``scale`` multiply, then cast back
    (``deepspeed_tpu/models/llama.py:60-63``)."""

    def __init__(self, dim, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        h, kv, d, e = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
            cfg.hidden_size
        self.wq = QDense(e, h * d, device=device)
        self.wk = QDense(e, kv * d, device=device)
        self.wv = QDense(e, kv * d, device=device)
        self.wo = QDense(h * d, e, device=device)

    def forward(self, x, positions, cache=None):
        cfg = self.cfg
        b, l, _ = x.shape
        h, kv_h, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.wq(x).view(b, l, h, d)
        k = self.wk(x).view(b, l, kv_h, d)
        v = self.wv(x).view(b, l, kv_h, d)
        q = apply_rotary_emb(q, positions, base=cfg.rope_base)
        k = apply_rotary_emb(k, positions, base=cfg.rope_base)

        new_cache = None
        if cache is None:
            k_full, v_full = _repeat_kv(k, h // kv_h), _repeat_kv(v, h // kv_h)
            if resolve_attn_impl(cfg.attn_impl, x.device) == "flash":
                out = flash_attention(q, k_full, v_full, causal=True)
            else:
                out = mha_reference(q, k_full, v_full, causal=True)
        elif "k_pages" in cache:
            out = paged_cache_attention(q, k, v, positions, cache)
        else:                            # dense cache (generate)
            out, new_cache = dense_cache_attention(q, k, v, cache, positions)
        out = out.to(x.dtype).reshape(b, l, h * d)
        return self.wo(out), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.w_gate = QDense(e, m, device=device)
        self.w_up = QDense(e, m, device=device)
        self.w_down = QDense(m, e, device=device)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        self.attn = LlamaAttention(cfg, device=device)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                      device=device)
        self.mlp = LlamaMLP(cfg, device=device)

    def forward(self, x, positions, cache=None):
        attn_out, new_cache = self.attn(self.input_norm(x), positions, cache)
        x = x + attn_out
        x = x + self.mlp(self.post_attn_norm(x))
        return x, new_cache


class Llama(nn.Module):
    """Returns logits [b, l, vocab]; with ``cache`` returns (logits, cache).

    A paged ``cache`` holds ``layers`` (pool dicts), ``page_table``
    [slots, max_pages] and ``lengths`` [slots] (int32, on the device),
    plus either ``slot``/``n_valid`` (Python ints: one prefill chunk of
    one slot, ``ids`` [1, chunk]; only the boundary row's logits are
    returned), ``widths`` [slots] int32 (speculative verify, ``ids``
    [slots, K+1]: the columns each slot writes, 0 for an inactive slot;
    lengths advance by them and the engine rewinds after acceptance) or
    ``active`` [slots] bool (one decode token per slot; inactive slots
    write to the sink and do not advance)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        # on the meta device (an HF module before the engine fills it)
        # there is nothing to draw, and normal_ there first imports
        # torch._dynamo, seconds of the first ingestion
        empty = torch.empty(cfg.vocab_size, cfg.hidden_size, device="meta") \
            if device is not None and torch.device(device).type == "meta" \
            else None
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, _weight=empty)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size,
                                  device=device)

    def forward(self, input_ids, positions=None, cache=None):
        b, l = input_ids.shape
        dev = input_ids.device
        paged = cache is not None and "page_table" in cache
        if positions is None:
            if paged:
                lens = cache["lengths"]
                if "slot" in cache:
                    positions = (lens[cache["slot"]] +
                                 torch.arange(l, device=dev))[None, :]
                elif "widths" in cache:
                    positions = lens[:, None] + torch.arange(l, device=dev)
                else:
                    positions = lens[:, None]
            elif cache is not None:
                start = cache["layers"][0]["index"]
                positions = torch.arange(start, start + l, device=dev)[None]
            else:
                positions = torch.arange(l, device=dev)[None]
            positions = positions.expand(b, l)

        x = self.embed_tokens(input_ids)
        new_layers = []
        for i, block in enumerate(self.layers):
            layer_cache = None if cache is None else cache["layers"][i]
            if paged:
                layer_cache = dict(layer_cache,
                                   page_table=cache["page_table"])
                for key in ("slot", "n_valid", "active", "widths"):
                    if key in cache:
                        layer_cache[key] = cache[key]
            x, new_c = block(x, positions, layer_cache)
            new_layers.append(new_c)

        if paged and "slot" in cache:
            # chunked prefill consumes only the boundary row
            n = cache["n_valid"]
            x = x[:, n - 1:n]
        x = self.norm(x)
        if self.cfg.tie_embeddings:
            logits = torch.einsum("ble,ve->blv", x,
                                  self.embed_tokens.weight.to(x.dtype))
        else:
            logits = self.lm_head(x)
        if paged:
            lens = cache["lengths"]
            if "slot" in cache:
                lengths = lens.clone()
                lengths[cache["slot"]] += cache["n_valid"]
            elif "widths" in cache:
                lengths = lens + cache["widths"].to(lens.dtype)
            else:
                lengths = lens + cache["active"].to(lens.dtype)
            return logits, dict(cache, lengths=lengths)
        if cache is not None:
            return logits, {"layers": new_layers}
        return logits


def llama_params_from_jax(tree):
    """The JAX ``Llama`` param tree (nested dicts of numpy arrays, already
    unboxed) -> this module's ``state_dict``.  Each ``QDense`` ``kernel``
    [in, out] becomes a ``weight`` [out, in]; ``embed_tokens``, the
    ``RMSNorm`` scales and ``lm_head`` (absent from a tied tree) carry
    over."""
    def t(a):
        return torch.from_numpy(np.array(a, order="C"))

    out = {"embed_tokens.weight": t(tree["embed_tokens"]),
           "norm.scale": t(tree["norm"]["scale"])}
    if "lm_head" in tree:
        out["lm_head.weight"] = t(np.asarray(tree["lm_head"]["kernel"]).T)
    i = 0
    while f"layers_{i}" in tree:
        layer = tree[f"layers_{i}"]
        for norm in ("input_norm", "post_attn_norm"):
            out[f"layers.{i}.{norm}.scale"] = t(layer[norm]["scale"])
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                out[f"layers.{i}.{group}.{name}.weight"] = \
                    t(layer[group][name]["kernel"].T)
        i += 1
    return out


def llama_jax_path(name, ndim):
    """(JAX param path, transposed) of a ``state_dict`` name: ``layers.
    {i}`` -> ``layers_{i}``, ``embed_tokens.weight`` -> ``embed_tokens``,
    a ``QDense`` ``weight`` -> ``kernel`` (transposed)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layers_{parts[1]}"] + parts[2:]
    if parts == ["embed_tokens", "weight"]:
        return ("embed_tokens",), False
    if parts[-1] == "weight":
        parts[-1] = "kernel"
        return tuple(parts), True
    return tuple(parts), False


def llama_params_to_jax(state_dict):
    """The inverse of :func:`llama_params_from_jax`: this module's float
    ``state_dict`` -> the JAX ``Llama`` param tree (no ``lm_head`` when
    tied; ``kernel`` [in, out] a transposed view of ``weight``).  The
    values are the given tensors (views, no copies)."""
    tree = {}
    for name, value in state_dict.items():
        path, transposed = llama_jax_path(name, value.ndim)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.t() if transposed else value
    return tree


def _dense_layers(tree):
    """(port module name, JAX ``QDense`` param dict) of every projection
    (``lm_head`` unless the tree is tied)."""
    out = [("lm_head", tree["lm_head"])] if "lm_head" in tree else []
    i = 0
    while f"layers_{i}" in tree:
        layer = tree[f"layers_{i}"]
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down"))):
            out += [(f"layers.{i}.{group}.{name}", layer[group][name])
                    for name in names]
        i += 1
    return out


def load_quantized_params_from_jax(module, tree):
    """Carry a JAX ``Llama`` param tree whose ``kernel`` leaves may be
    quantized into ``module``, in place.  A quantized leaf is anything
    with ``q``, ``scale``, ``dtype``, ``bits`` and ``group_size``
    attributes (the JAX ``QTensor``, arrays convertible with
    ``numpy.asarray``): its ``q`` and ``scale`` are taken as they are —
    the port keeps the JAX ``[in, out]`` orientation — and the layer
    computes in the dtype the leaf names.  Float leaves carry over as in
    :func:`llama_params_from_jax`, cast to the module's dtype.  Returns
    ``module``."""
    def t(a):
        return torch.from_numpy(np.array(a))

    layers = dict(module.named_modules())
    with torch.no_grad():
        module.embed_tokens.weight.copy_(t(tree["embed_tokens"]))
        module.norm.scale.copy_(t(tree["norm"]["scale"]))
        for i, block in enumerate(module.layers):
            for norm in ("input_norm", "post_attn_norm"):
                getattr(block, norm).scale.copy_(
                    t(tree[f"layers_{i}"][norm]["scale"]))
        for name, params in _dense_layers(tree):
            kernel, layer = params["kernel"], layers[name]
            if hasattr(kernel, "scale"):
                dtype = getattr(torch, np.dtype(kernel.dtype).name)
                layer.set_qtensor_(QTensor(
                    t(kernel.q), t(kernel.scale), dtype, kernel.bits,
                    kernel.group_size))
            elif layer.quantized:
                raise ValueError(f"{name} is quantized but the tree holds "
                                 "a float kernel for it")
            else:
                layer.weight.copy_(t(kernel).T)
    return module


def llama_tiny(**overrides):
    """Test-fixture scale (the JAX package's ``llama_tiny``)."""
    kwargs = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=128, max_seq_len=128)
    kwargs.update(overrides)
    return LlamaConfig(**kwargs)


def llama2_7b(**overrides):
    return LlamaConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=32, intermediate_size=11008, max_seq_len=4096),
        **overrides})


def llama2_70b(**overrides):
    return LlamaConfig(**{**dict(
        vocab_size=32000, hidden_size=8192, num_layers=80, num_heads=64,
        num_kv_heads=8, intermediate_size=28672, max_seq_len=4096),
        **overrides})
