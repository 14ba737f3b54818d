"""GPT-2-family causal transformer, training path (counterpart of
``deepspeed_tpu/models/gpt2.py``).

``GPT2(cfg)(input_ids)`` returns logits [b, l, vocab].  The parameters
are fp32 masters named after the flax tree (``wte``, ``wpe``,
``h.{i}.ln_1`` / ``attn.qkv`` / ``attn.proj`` / ``ln_2`` /
``mlp.fc_in`` / ``mlp.fc_out``, ``ln_f``); the forward casts each one to
``cfg.dtype`` inside autograd, so a bf16 forward leaves fp32 gradients
on the masters (the engine's ``cast()``, ``runtime/engine.py:790-793``).
A fresh module's parameters are uninitialised: the engine draws them
from a seed (:func:`init_gpt2_params`) or loads carried weights.

What is ported is the training branch: pre-LN blocks (eps 1e-5), a fused
biased ``qkv`` projection split in three, tanh-GELU (exact GELU with
``activation="gelu_exact"``), learned positions and the head tied to
``wte`` computed in the compute dtype.  Attention takes ``attn_impl``:
``"flash"`` (``ops/attention/flash.py``: the kernels on a CUDA tensor,
their plain versions on a CPU one), ``"reference"`` (plain attention)
or ``"auto"`` (flash on a CUDA tensor, reference on a CPU one).  The
other branches of the JAX model raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.attention.flash import (flash_attention,
                                                     resolve_attn_impl)
from deepspeed_tpu_torch.ops.attention.reference import mha_reference

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    activation: str = "gelu"               # "gelu" (tanh) | "gelu_exact"
    # JAX-model features this slice does not run: set, they raise
    dropout: float = 0.0
    remat: bool = False
    scan_layers: bool = False
    moe_num_experts: int = 0
    use_alibi: bool = False
    rotary_dim: int = 0
    attn_windows: tuple = ()

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", DTYPES[self.dtype])
        if self.dtype not in DTYPES.values():
            raise ValueError(f"unsupported GPT-2 compute dtype {self.dtype}")
        resolve_attn_impl(self.attn_impl, torch.device("cpu"))
        if self.activation not in ("gelu", "gelu_exact"):
            raise ValueError(f"unknown activation {self.activation!r}")
        for name, on, item in (
                ("dropout", self.dropout > 0,
                 "Queue A14 (dropout with an explicit generator)"),
                ("remat", self.remat,
                 "Queue A13 (activation checkpointing)"),
                ("scan_layers", self.scan_layers,
                 "Queue A13 (activation checkpointing)"),
                ("moe_num_experts", self.moe_num_experts > 1,
                 "Queue A10 (MoE)"),
                ("use_alibi", self.use_alibi, "Queue A7 (ALiBi variants)"),
                ("rotary_dim", self.rotary_dim > 0,
                 "Queue A7 (rotary GPT-J/NeoX variants)"),
                ("attn_windows", any(self.attn_windows),
                 "Queue A7 (GPT-Neo local attention)")):
            if on:
                raise _unported(f"GPTConfig.{name}="
                                f"{getattr(self, name)!r}", item)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


class Dense(nn.Module):
    """``x @ W^T + b`` with W and b cast to the compute dtype (flax
    ``kernel`` [in, out] is stored as ``weight`` [out, in])."""

    def __init__(self, in_features, out_features, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x, dtype):
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


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
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size, device)
        self.proj = Dense(cfg.hidden_size, cfg.hidden_size, device)

    def forward(self, x):
        cfg = self.cfg
        b, l, e = x.shape
        q, k, v = self.qkv(x, cfg.dtype).split(e, dim=-1)
        shape = (b, l, cfg.num_heads, cfg.head_dim)
        q, k, v = q.view(shape), k.view(shape), v.view(shape)
        if resolve_attn_impl(cfg.attn_impl, x.device) == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            out = mha_reference(q, k, v, causal=True)
        return self.proj(out.reshape(b, l, e), cfg.dtype)


class MLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.fc_in = Dense(cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size,
                           device)
        self.fc_out = Dense(cfg.mlp_ratio * cfg.hidden_size, cfg.hidden_size,
                            device)

    def forward(self, x):
        cfg = self.cfg
        h = F.gelu(self.fc_in(x, cfg.dtype),
                   approximate="none" if cfg.activation == "gelu_exact"
                   else "tanh")
        return self.fc_out(h, cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.attn = SelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x, self.cfg.dtype))
        return x + self.mlp(self.ln_2(x, self.cfg.dtype))


class GPT2(nn.Module):
    """Logits [batch, len, vocab] of ``input_ids`` [batch, len]."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size,
                                            device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.hidden_size,
                                            device=device))
        self.h = nn.ModuleList(Block(cfg, device)
                               for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, input_ids, positions=None, cache=None,
                pld_theta=None, rltd_keep=None):
        cfg = self.cfg
        if cache is not None:
            raise _unported("GPT-2 with a KV cache (dense or paged)",
                            "Queue A7 (GPT-2 serving)")
        if pld_theta is not None:
            raise _unported("progressive layer drop", "Queue A16")
        if rltd_keep is not None:
            raise _unported("random-LTD token dropping", "Queue A16")
        b, l = input_ids.shape
        if positions is None:
            positions = torch.arange(l, device=input_ids.device)[None]
        wte = self.wte.to(cfg.dtype)        # one cast feeds lookup and head
        x = F.embedding(input_ids, wte) + \
            F.embedding(positions, self.wpe.to(cfg.dtype))
        for block in self.h:
            x = block(x)
        x = self.ln_f(x, cfg.dtype)
        return torch.einsum("ble,ve->blv", x, wte)


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


def gpt2_params_from_jax(tree):
    """An unboxed JAX ``GPT2`` param tree (nested dicts of numpy arrays) ->
    this module's ``state_dict``: flax ``kernel`` [in, out] -> ``weight``
    [out, in], LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``,
    ``wte`` and ``wpe`` as they are."""
    def t(a):
        return torch.from_numpy(a.copy())

    def norm(prefix, node):
        return {f"{prefix}.weight": t(node["scale"]),
                f"{prefix}.bias": t(node["bias"])}

    def dense(prefix, node):
        return {f"{prefix}.weight": t(node["kernel"].T),
                f"{prefix}.bias": t(node["bias"])}

    out = {"wte": t(tree["wte"]), "wpe": t(tree["wpe"]),
           **norm("ln_f", tree["ln_f"])}
    i = 0
    while f"h_{i}" in tree:
        layer, pre = tree[f"h_{i}"], f"h.{i}"
        out.update(norm(f"{pre}.ln_1", layer["ln_1"]))
        out.update(norm(f"{pre}.ln_2", layer["ln_2"]))
        for group, names in (("attn", ("qkv", "proj")),
                             ("mlp", ("fc_in", "fc_out"))):
            for name in names:
                out.update(dense(f"{pre}.{group}.{name}",
                                 layer[group][name]))
        i += 1
    return out


def gpt2_small(**overrides):
    """HF GPT-2 small (``gpt2.py:732``)."""
    return GPTConfig(**{**dict(vocab_size=50257, hidden_size=768,
                               num_layers=12, num_heads=12,
                               max_seq_len=1024), **overrides})


def gpt2_tiny(**overrides):
    """Test-fixture scale (``gpt2.py:737``)."""
    return GPTConfig(**{**dict(vocab_size=256, hidden_size=64, num_layers=2,
                               num_heads=4, max_seq_len=128), **overrides})
