"""GPT-2-family causal transformer for training and serving
(counterpart of ``deepspeed_tpu/models/gpt2.py``).

``GPT2(cfg)(input_ids)`` returns logits [b, l, vocab]; with ``cache`` it
returns ``(logits, cache)``, the contract of ``models/llama.py``.  The
parameters are fp32 masters named after the flax tree (``wte``, ``wpe``,
``ln_embed``, ``h.{i}.ln_1`` / ``attn.qkv`` / ``attn.proj`` / ``ln_2`` /
``mlp.fc_in`` / ``mlp.fc_out``, ``ln_f``, ``lm_head``); the forward casts
each one to ``cfg.dtype`` inside autograd, so a bf16 forward leaves fp32
gradients on the masters (the engine's ``cast()``,
``runtime/engine.py:790-793``).  A fresh module's parameters are
uninitialised: the engines draw them from a seed
(:func:`init_gpt2_params`) or load carried weights.

The config's variant fields are the JAX model's and cover its
families (``deepspeed_tpu/module_inject/policy.py``): GPT-2 (pre-LN,
fused biased ``qkv``, tanh-GELU, learned positions, head tied to
``wte``), OPT (ReLU, positions stored at index + 2), BLOOM (ALiBi, an
embedding LayerNorm), GPT-J (interleaved partial rotary, parallel
residual off one LayerNorm, unbiased attention, an untied biased head),
GPT-NeoX / Pythia (NeoX partial rotary, parallel residual, untied head)
and GPT-Neo (alternating global and local-window layers, unbiased
``qkv``).  Attention without a cache takes ``attn_impl``: ``"flash"``
(``ops/attention/flash.py``: the kernels on a CUDA tensor, their plain
versions on a CPU one), ``"reference"`` (plain attention) or ``"auto"``
(flash on a CUDA tensor, reference on a CPU one); ALiBi and local
windows take the plain attention with their bias, as in the JAX model.

Caches are ``models/kv_cache.py``'s, updated in place: a dense layer
dict (``k`` / ``v`` buffers and a Python ``index``) for ``generate()``,
where one query token on a CUDA tensor runs ``decode_fwd`` with the
validity mask, the local window and ALiBi in its bias; and the paged
pools of ``ops/quant/kv.py`` (float, int8 or fp8) for the chunked prefill
(``"slot"``), the speculative verify (``"widths"``) and the
continuous-batch decode (``"active"``: ``paged_decode_fwd`` /
``paged_decode_quant_fwd``, or with ALiBi the gathered pages through
``decode_fwd``).  Paged serving of local windows is refused, as the JAX
model refuses it; sequence-parallel prefill and LoRA adapters are
ROADMAP.md Queue A10.  Every projection is a ``QDense``: float, or
weight-only int8 after ``ops/quant/quantizer.quantize_tree``.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.kv_cache import (  # noqa: F401
    cache_bias, dense_cache_attention, init_kv_cache, init_paged_kv_cache,
    paged_cache_attention)
from deepspeed_tpu_torch.ops.attention.flash import (flash_attention,
                                                     resolve_attn_impl)
from deepspeed_tpu_torch.ops.attention.reference import (apply_partial_rotary,
                                                         mha_reference)
from deepspeed_tpu_torch.ops.quant.qdense import QDense, quant_matmul
from deepspeed_tpu_torch.ops.quant.quantizer import QTensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
ACTIVATIONS = ("gelu", "gelu_exact", "relu")
PAGED_WINDOWS_REFUSED = (
    "paged serving of local attention windows (GPT-Neo) is not supported: "
    "the JAX model refuses it too ('paged serving does not support local "
    "attn_windows yet', deepspeed_tpu/models/gpt2.py:155-156); use "
    "generate()")


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               f"package yet: see ROADMAP.md {item}")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32    # compute dtype
    attn_impl: str = "auto"                # "auto" | "reference" | "flash"
    layer_norm_eps: float = 1e-5
    activation: str = "gelu"               # "gelu" (tanh) | "gelu_exact" | "relu"
    use_bias: bool = True
    tie_embeddings: bool = True
    pos_embed: str = "learned"             # "learned" | "none" (rotary/ALiBi)
    pos_offset: int = 0                    # OPT stores positions at index+2
    embed_layernorm: bool = False          # BLOOM word_embeddings_layernorm
    use_alibi: bool = False                # BLOOM attention bias
    rotary_dim: int = 0                    # >0: rotary on the first dims
    rotary_interleaved: bool = False       # GPT-J rotate-every-two
    rope_base: float = 10000.0
    parallel_residual: bool = False        # x + attn(ln1 x) + mlp(...)
    single_ln: bool = False                # GPT-J: mlp reads ln_1's output
    attn_bias: Optional[bool] = None       # None: use_bias
    qkv_bias: Optional[bool] = None        # None: attn_bias (GPT-Neo: False)
    # per-layer local-attention windows (GPT-Neo): entry i is layer i's
    # window, 0 = full causal; empty = all global
    attn_windows: tuple = ()
    lm_head_bias: bool = False             # GPT-J lm_head carries a bias
    # JAX-model features this port does not run: set, they raise
    dropout: float = 0.0
    remat: bool = False
    scan_layers: bool = False
    moe_num_experts: int = 0

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", DTYPES[self.dtype])
        if self.dtype not in DTYPES.values():
            raise ValueError(f"unsupported GPT-2 compute dtype {self.dtype}")
        object.__setattr__(self, "attn_windows", tuple(self.attn_windows))
        resolve_attn_impl(self.attn_impl, torch.device("cpu"))
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.pos_embed not in ("learned", "none"):
            raise ValueError(f"unknown pos_embed {self.pos_embed!r}")
        if self.rotary_dim % 2 or self.rotary_dim > self.head_dim:
            raise ValueError(f"rotary_dim={self.rotary_dim} must be even "
                             f"and at most head_dim={self.head_dim}")
        for name, on, item in (
                ("dropout", self.dropout > 0,
                 "Queue A14 (dropout with an explicit generator)"),
                ("remat", self.remat,
                 "Queue A13 (activation checkpointing)"),
                ("scan_layers", self.scan_layers,
                 "Queue A13 (activation checkpointing)"),
                ("moe_num_experts", self.moe_num_experts > 1,
                 "Queue A10 (MoE)")):
            if on:
                raise _unported(f"GPTConfig.{name}="
                                f"{getattr(self, name)!r}", item)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self):
        """Every GPT-2-family model here is multi-head: one kv head per
        query head (the pools' and the serving engine's view)."""
        return self.num_heads

    def window(self, layer):
        """Layer ``layer``'s local-attention window, 0 for full causal."""
        return self.attn_windows[layer] if layer < len(self.attn_windows) \
            else 0


def alibi_slopes(num_heads):
    """ALiBi per-head slopes, float32 (BLOOM attention; Press et al.'s
    closed form, ``deepspeed_tpu/models/gpt2.py:96-108``): computed in
    Python floats, then rounded once."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = pow2_slopes(closest) + \
            pow2_slopes(2 * closest)[0::2][:num_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32)


class Dense(QDense):
    """``x @ W^T + b`` in the compute dtype ``dtype`` (flax ``kernel``
    [in, out] is stored as ``weight`` [out, in]): a float weight and its
    bias are cast to ``dtype`` first; a quantized one (``QDense.
    quantize_``) runs ``quant_matmul`` on ``x`` in ``dtype`` and adds the
    bias after, as the JAX ``QDense`` does with ``dtype=cfg.dtype``."""

    def __init__(self, in_features, out_features, use_bias=True,
                 device=None):
        super().__init__(in_features, out_features, use_bias=use_bias,
                         device=device)

    def reset_parameters(self):
        """Left uninitialised: the engines draw or load the weights."""

    def forward(self, x, dtype):
        bias = None if self.bias is None else self.bias.to(dtype)
        if self.quantized:
            y = quant_matmul(x.to(dtype), self.kernel)
            return y if bias is None else y + bias
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: fp32 mean and fast variance
    ``max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * rsqrt(var + eps) * scale
    + bias`` in fp32 with scale/bias cast to the compute dtype first, the
    result cast to the compute dtype."""

    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x, dtype):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dtype).float()
        y = (xf - mean) * mul + self.bias.to(dtype).float()
        return y.to(dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg, window=0, device=None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        attn_bias = cfg.use_bias if cfg.attn_bias is None else cfg.attn_bias
        qkv_bias = attn_bias if cfg.qkv_bias is None else cfg.qkv_bias
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size, qkv_bias,
                         device)
        self.proj = Dense(cfg.hidden_size, cfg.hidden_size, attn_bias,
                          device)

    def forward(self, x, positions, cache=None, alibi=None):
        """``alibi``: the [1, heads, 1, k_len] ALiBi term over the keys this
        call attends (``GPT2.forward`` builds it once per call)."""
        cfg = self.cfg
        b, l, e = x.shape
        q, k, v = self.qkv(x, cfg.dtype).split(e, dim=-1)
        shape = (b, l, cfg.num_heads, cfg.head_dim)
        q, k, v = q.view(shape), k.view(shape), v.view(shape)
        if cfg.rotary_dim:
            rot = dict(base=cfg.rope_base,
                       interleaved=cfg.rotary_interleaved)
            q = apply_partial_rotary(q, positions, cfg.rotary_dim, **rot)
            k = apply_partial_rotary(k, positions, cfg.rotary_dim, **rot)

        new_cache = None
        if cache is None:
            out = self._no_cache(q, k, v, alibi)
        elif "k_pages" in cache:
            if self.window > 0:
                raise NotImplementedError(PAGED_WINDOWS_REFUSED)
            out = paged_cache_attention(q, k, v, positions, cache, alibi)
        else:                            # dense cache (generate)
            out, new_cache = dense_cache_attention(q, k, v, cache, positions,
                                                   self.window, alibi)
        out = out.to(cfg.dtype).reshape(b, l, e)
        return self.proj(out, cfg.dtype), new_cache

    def _no_cache(self, q, k, v, alibi):
        cfg, l = self.cfg, q.shape[1]
        if self.window > 0:
            # GPT-Neo "local": query i attends to keys in (i - window, i]
            bias = cache_bias(l, torch.arange(l, device=q.device)[None],
                              self.window)
            return mha_reference(q, k, v, causal=False, bias=bias)
        if alibi is not None:
            return mha_reference(q, k, v, causal=True, bias=alibi)
        if resolve_attn_impl(cfg.attn_impl, q.device) == "flash":
            return flash_attention(q, k, v, causal=True)
        return mha_reference(q, k, v, causal=True)


class MLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.fc_in = Dense(cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size,
                           cfg.use_bias, device)
        self.fc_out = Dense(cfg.mlp_ratio * cfg.hidden_size, cfg.hidden_size,
                            cfg.use_bias, device)

    def forward(self, x):
        cfg = self.cfg
        h = self.fc_in(x, cfg.dtype)
        if cfg.activation == "relu":
            h = F.relu(h)
        else:
            h = F.gelu(h, approximate="none" if cfg.activation == "gelu_exact"
                       else "tanh")
        return self.fc_out(h, cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg, window=0, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.attn = SelfAttention(cfg, window, device)
        if not (cfg.parallel_residual and cfg.single_ln):
            self.ln_2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                  device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions, cache=None, alibi=None):
        dtype = self.cfg.dtype
        ln1 = self.ln_1(x, dtype)
        attn_out, new_cache = self.attn(ln1, positions, cache, alibi)
        if self.cfg.parallel_residual:
            # GPT-J / GPT-NeoX: attention and MLP branch off one input;
            # GPT-J (single_ln) feeds the MLP ln_1's output
            h = ln1 if self.cfg.single_ln else self.ln_2(x, dtype)
            return x + attn_out + self.mlp(h), new_cache
        x = x + attn_out
        return x + self.mlp(self.ln_2(x, dtype)), new_cache


class GPT2(nn.Module):
    """Logits [batch, len, vocab] of ``input_ids`` [batch, len]; with
    ``cache`` (``init_kv_cache`` / ``init_paged_kv_cache`` plus the keys
    of ``models/kv_cache.py`` and ``Llama.forward``: ``lengths`` and one
    of ``slot`` / ``n_valid``, ``widths`` or ``active``) returns
    (logits, cache)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size,
                                            device=device))
        if cfg.pos_embed == "learned":
            self.wpe = nn.Parameter(torch.empty(
                cfg.max_seq_len + cfg.pos_offset, cfg.hidden_size,
                device=device))
        if cfg.embed_layernorm:
            self.ln_embed = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                      device)
        self.h = nn.ModuleList(Block(cfg, cfg.window(i), device)
                               for i in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size,
                                 cfg.lm_head_bias, device)
        # the ALiBi slopes per device, built once (graph bodies replay
        # them; a host tensor per step would be a copy per step)
        self._slopes = {}

    def _alibi(self, k_len, device):
        """[1, heads, 1, k_len] fp32: slope x key position.  Softmax is
        shift-invariant per query row, so this equals slope x (key -
        query position) (``deepspeed_tpu/models/gpt2.py:296-299``)."""
        slopes = self._slopes.get(device)
        if slopes is None:
            slopes = self._slopes[device] = alibi_slopes(
                self.cfg.num_heads).to(device)
        k_pos = torch.arange(k_len, device=device)
        return slopes[None, :, None, None] * k_pos[None, None, None, :]

    def forward(self, input_ids, positions=None, cache=None,
                pld_theta=None, rltd_keep=None):
        cfg = self.cfg
        if pld_theta is not None:
            raise _unported("progressive layer drop", "Queue A16")
        if rltd_keep is not None:
            raise _unported("random-LTD token dropping", "Queue A16")
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
                positions = positions.expand(b, l)
            elif cache is not None:
                start = cache["layers"][0]["index"]
                positions = torch.arange(start, start + l,
                                         device=dev)[None].expand(b, l)
            else:
                positions = torch.arange(l, device=dev)[None]
        wte = self.wte.to(cfg.dtype)        # one cast feeds lookup and head
        x = F.embedding(input_ids, wte)
        if cfg.pos_embed == "learned":
            idx = positions + cfg.pos_offset
            if cache is not None:
                # padded rows of a prefill chunk or a verify may run past
                # the table: JAX clamps such gathers, so does this
                idx = idx.clamp(max=self.wpe.shape[0] - 1)
            x = x + F.embedding(idx, self.wpe.to(cfg.dtype))
        if cfg.embed_layernorm:
            x = self.ln_embed(x, cfg.dtype)

        alibi = None
        if cfg.use_alibi:        # over the keys the layers attend
            if cache is None:
                k_len = l
            elif paged:
                k_len = cache["page_table"].shape[1] * \
                    cache["layers"][0]["k_pages"].shape[1]
            else:
                k_len = cache["layers"][0]["k"].shape[1]
            alibi = self._alibi(k_len, dev)
        new_layers = []
        for i, block in enumerate(self.h):
            layer_cache = None if cache is None else cache["layers"][i]
            if paged:
                layer_cache = dict(layer_cache,
                                   page_table=cache["page_table"])
                for key in ("slot", "n_valid", "active", "widths"):
                    if key in cache:
                        layer_cache[key] = cache[key]
            x, new_c = block(x, positions, layer_cache, alibi)
            new_layers.append(new_c)

        if paged and "slot" in cache:
            # chunked prefill consumes only the boundary row
            n = cache["n_valid"]
            x = x[:, n - 1:n]
        x = self.ln_f(x, cfg.dtype)
        if cfg.tie_embeddings:
            logits = torch.einsum("ble,ve->blv", x, wte)
        else:
            logits = self.lm_head(x, cfg.dtype)
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


def gpt2_loss_fn(logits, batch):
    """Mean next-token cross-entropy (``gpt2.py:635``): ``batch["labels"]``
    (already shifted, -100 ignored) or the shifted ``input_ids``."""
    labels = batch.get("labels")
    if labels is None:
        ids = batch["input_ids"]
        labels = F.pad(ids[:, 1:], (0, 1), value=-100)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits.float(), dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0].float()
    nll = (logz - ll) * valid
    return nll.sum() / valid.sum().clamp_min(1)


@torch.no_grad()
def init_gpt2_params(model, generator):
    """The flax initializers of the JAX model, drawn from ``generator``:
    normal(0.02) for ``wte`` and every Dense weight, normal(0.01) for
    ``wpe``, zeros for biases, ones for LayerNorm scales."""
    for name, p in model.named_parameters():
        if name == "wpe":
            p.normal_(0.0, 0.01, generator=generator)
        elif name == "wte" or (name.endswith(".weight") and p.ndim == 2):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith(".weight"):
            p.fill_(1.0)
        else:
            p.zero_()


def _blocks(tree):
    i = 0
    while f"h_{i}" in tree:
        yield i, tree[f"h_{i}"]
        i += 1


def _norm_layers(tree):
    """(port module name, JAX LayerNorm param dict) of every LayerNorm."""
    out = [(name, tree[name]) for name in ("ln_embed", "ln_f")
           if name in tree]
    for i, layer in _blocks(tree):
        out += [(f"h.{i}.{name}", layer[name]) for name in ("ln_1", "ln_2")
                if name in layer]
    return out


def _dense_layers(tree):
    """(port module name, JAX ``QDense`` param dict) of every projection:
    the qkv, proj, fc_in and fc_out of each block and an untied
    ``lm_head`` (JAX ``_dense``, ``models/gpt2.py:84-93``)."""
    out = [("lm_head", tree["lm_head"])] if "lm_head" in tree else []
    for i, layer in _blocks(tree):
        for group, names in (("attn", ("qkv", "proj")),
                             ("mlp", ("fc_in", "fc_out"))):
            out += [(f"h.{i}.{group}.{name}", layer[group][name])
                    for name in names]
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def gpt2_params_from_jax(tree):
    """An unboxed JAX ``GPT2`` param tree (nested dicts of numpy arrays) of
    any variant -> this module's ``state_dict``: flax ``kernel`` [in, out]
    -> ``weight`` [out, in] and its ``bias`` where the layer has one,
    LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``, ``wte`` and
    (learned positions; OPT's has ``pos_offset`` extra rows) ``wpe`` as
    they are."""
    out = {name: _t(tree[name]) for name in ("wte", "wpe") if name in tree}
    for prefix, node in _norm_layers(tree):
        out[f"{prefix}.weight"] = _t(node["scale"])
        out[f"{prefix}.bias"] = _t(node["bias"])
    for prefix, node in _dense_layers(tree):
        out[f"{prefix}.weight"] = _t(node["kernel"]).T.contiguous()
        if "bias" in node:
            out[f"{prefix}.bias"] = _t(node["bias"])
    return out


def _nest(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def gpt2_jax_path(name, ndim):
    """(JAX param path, transposed) of a ``state_dict`` name: ``h.{i}``
    -> ``h_{i}``, a Dense ``weight`` -> ``kernel`` (transposed), a
    LayerNorm ``weight`` -> ``scale``."""
    parts = name.split(".")
    if parts[0] == "h":
        parts = [f"h_{parts[1]}"] + parts[2:]
    if len(parts) > 1 and parts[-1] == "weight":
        parts[-1] = "kernel" if ndim == 2 else "scale"
        return tuple(parts), ndim == 2
    return tuple(parts), False


def gpt2_params_to_jax(state_dict):
    """The inverse of :func:`gpt2_params_from_jax`: this module's float
    ``state_dict`` -> the JAX ``GPT2`` param tree (nested dicts named as
    the flax tree, ``kernel`` [in, out] a transposed view of ``weight``).
    The values are the given tensors (views, no copies)."""
    tree = {}
    for name, value in state_dict.items():
        path, transposed = gpt2_jax_path(name, value.ndim)
        _nest(tree, path, value.t() if transposed else value)
    return tree


def load_quantized_params_from_jax(module, tree):
    """Carry a JAX ``GPT2`` param tree whose ``kernel`` leaves may be
    quantized into ``module``, in place (``models/llama.py``'s function
    over GPT-2's layers).  A quantized leaf is anything with ``q``,
    ``scale``, ``dtype``, ``bits`` and ``group_size`` attributes (the JAX
    ``QTensor``): its ``q`` and ``scale`` are taken as they are, in the
    JAX ``[in, out]`` orientation.  Embeddings, LayerNorms, biases and
    float kernels carry over as in :func:`gpt2_params_from_jax`, cast to
    the module's dtype.  Returns ``module``."""
    layers = dict(module.named_modules())
    with torch.no_grad():
        for name in ("wte", "wpe"):
            if name in tree:
                getattr(module, name).copy_(_t(tree[name]))
        for prefix, node in _norm_layers(tree):
            layers[prefix].weight.copy_(_t(node["scale"]))
            layers[prefix].bias.copy_(_t(node["bias"]))
        for name, params in _dense_layers(tree):
            kernel, layer = params["kernel"], layers[name]
            if hasattr(kernel, "scale"):
                dtype = getattr(torch, np.dtype(kernel.dtype).name)
                layer.set_qtensor_(QTensor(
                    _t(kernel.q), _t(kernel.scale), dtype, kernel.bits,
                    kernel.group_size))
            elif layer.quantized:
                raise ValueError(f"{name} is quantized but the tree holds "
                                 "a float kernel for it")
            else:
                layer.weight.copy_(_t(kernel).T)
            if "bias" in params:
                layer.bias.copy_(_t(params["bias"]))
    return module


def gpt2_small(**overrides):
    """HF GPT-2 small (``gpt2.py:732``)."""
    return GPTConfig(**{**dict(vocab_size=50257, hidden_size=768,
                               num_layers=12, num_heads=12,
                               max_seq_len=1024), **overrides})


def gpt2_tiny(**overrides):
    """Test-fixture scale (``gpt2.py:737``)."""
    return GPTConfig(**{**dict(vocab_size=256, hidden_size=64, num_layers=2,
                               num_heads=4, max_seq_len=128), **overrides})
