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

Caches are dicts of tensors updated IN PLACE (the JAX model returned new
arrays): the dense layer dict carries ``k``/``v`` buffers and a Python
``index``; paged layers carry the pools of ``ops/quant/kv.py`` (whose
last page is the drop sink): two float leaves, or four when the pool is
quantized (int8 / fp8 payload plus per-row scale pools).  Attention runs
in the float pools' dtype (the query is cast to it); over quantized
pools it runs in the query's dtype, to which K/V dequantize.

Every projection is a ``QDense``: float, or weight-only int8 after
``ops/quant/quantizer.quantize_tree`` (the engine's ``quantize=``).
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.attention.decode import (_repeat_kv,
                                                      decode_attention,
                                                      paged_decode_attention)
from deepspeed_tpu_torch.ops.attention.flash import (flash_attention,
                                                     resolve_attn_impl)
from deepspeed_tpu_torch.ops.attention.reference import (apply_rotary_emb,
                                                         mha_reference)
from deepspeed_tpu_torch.ops.quant.kv import (paged_gather,
                                              paged_pool_layer, paged_write,
                                              sink_page)
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


def _validity_bias(max_len, positions):
    """Additive mask [b, l, max_len]: key j visible to a query at absolute
    position p iff j <= p."""
    k_pos = torch.arange(max_len, device=positions.device)
    return torch.where(k_pos[None, None, :] <= positions[:, :, None], 0.0,
                       torch.finfo(torch.float32).min)


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
            pt = cache["page_table"]
            ps, max_pages = cache["k_pages"].shape[1], pt.shape[1]
            # float pools: attend in the pool's dtype; quantized pools
            # dequantize to the query's (models/llama.py:160-161 of the
            # JAX package)
            attn_dtype = q.dtype if "k_scale" in cache \
                else cache["k_pages"].dtype
            sink = sink_page(cache)
            if "slot" in cache:          # chunked prefill (b == 1)
                slot, n_valid = cache["slot"], cache["n_valid"]
                pos = positions[0]
                valid = torch.arange(l, device=x.device) < n_valid
                # padded rows past n_valid land in the sink; their table
                # index is clamped (JAX clamps out-of-range gathers)
                page_ids = torch.where(
                    valid, pt[slot, (pos // ps).clamp(max=max_pages - 1)],
                    sink)
                paged_write(cache, page_ids, pos % ps, k[0], v[0])
                k_slot, v_slot = paged_gather(cache, pt[slot][None],
                                              attn_dtype)
                bias = _validity_bias(max_pages * ps, positions)[:, None]
                out = decode_attention(q.to(attn_dtype), k_slot, v_slot,
                                       bias=bias)
            elif "widths" in cache:      # speculative verify (l == K+1)
                # column j of slot s writes position lengths[s] + j when
                # j < widths[s] (0 for inactive slots); the rest land in
                # the sink, their table index clamped.  Every column then
                # attends causally over the slot's gathered pages: K+1
                # query rows take the plain attention, as in the JAX
                # package (models/llama.py:167-187 there)
                write = torch.arange(l, device=x.device)[None, :] < \
                    cache["widths"][:, None]
                rows = torch.arange(b, device=x.device)[:, None]
                page_ids = torch.where(
                    write,
                    pt[rows, (positions // ps).clamp(max=max_pages - 1)],
                    sink)
                paged_write(cache, page_ids, positions % ps, k, v)
                k_all, v_all = paged_gather(cache, pt, attn_dtype)
                bias = _validity_bias(max_pages * ps, positions)[:, None]
                out = decode_attention(q.to(attn_dtype), k_all, v_all,
                                       bias=bias)
            else:                        # continuous-batch decode (l == 1)
                pos = positions[:, 0]
                rows = torch.arange(b, device=x.device)
                page_ids = torch.where(
                    cache["active"],
                    pt[rows, (pos // ps).clamp(max=max_pages - 1)], sink)
                paged_write(cache, page_ids, pos % ps, k[:, 0], v[:, 0])
                out = paged_decode_attention(
                    q.to(attn_dtype), cache["k_pages"], cache["v_pages"],
                    pt, pos, k_scale=cache.get("k_scale"),
                    v_scale=cache.get("v_scale"))
        else:                            # dense cache (generate)
            index = cache["index"]
            k_cache, v_cache = cache["k"], cache["v"]
            k_cache[:, index:index + l] = k.to(k_cache.dtype)
            v_cache[:, index:index + l] = v.to(v_cache.dtype)
            new_cache = {"k": k_cache, "v": v_cache, "index": index + l}
            bias = _validity_bias(k_cache.shape[1], positions)[:, None]
            out = decode_attention(q.to(k_cache.dtype), k_cache, v_cache,
                                   bias=bias)
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
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size, device=device)

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
        logits = self.lm_head(self.norm(x))
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


def init_kv_cache(cfg, batch_size, max_len=None, dtype=torch.bfloat16,
                  device=None):
    """Empty dense KV cache (the ``generate()`` workspace)."""
    max_len = max_len or cfg.max_seq_len
    shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device),
                        "index": 0} for _ in range(cfg.num_layers)]}


def init_paged_kv_cache(cfg, num_pages, page_size, dtype=torch.bfloat16,
                        device=None):
    """Per-layer paged KV pools; GQA pools are sized to num_kv_heads and
    stay grouped through the paged kernel.  ``dtype`` is a torch float
    dtype or a quantized kv-dtype name ("int8" / "fp8": payload pools
    plus per-row f32 scale pools, ``ops/quant/kv.py``)."""
    return {"layers": [paged_pool_layer(num_pages, page_size,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        dtype, device=device)
                       for _ in range(cfg.num_layers)]}


def llama_params_from_jax(tree):
    """The JAX ``Llama`` param tree (nested dicts of numpy arrays, already
    unboxed) -> this module's ``state_dict``.  Each ``QDense`` ``kernel``
    [in, out] becomes a ``weight`` [out, in]; ``embed_tokens``, the
    ``RMSNorm`` scales and ``lm_head`` carry over."""
    def t(a):
        return torch.from_numpy(a.copy())

    out = {"embed_tokens.weight": t(tree["embed_tokens"]),
           "norm.scale": t(tree["norm"]["scale"]),
           "lm_head.weight": t(tree["lm_head"]["kernel"].T)}
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


def _dense_layers(tree):
    """(port module name, JAX ``QDense`` param dict) of every projection."""
    out = [("lm_head", tree["lm_head"])]
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
