"""Per-architecture ingestion policies (counterpart of
``deepspeed_tpu/module_inject/policy.py``).

A policy maps an HF config onto the port's native module (``GPT2`` with
its ``GPTConfig`` variant fields, or ``Llama``) and an HF state dict onto
that module's ``state_dict`` names directly.  HF ``nn.Linear`` weights
are already ``[out, in]``, the port's layout, so they pass as they are;
only GPT-2 / Megatron ``Conv1D`` weights (``[in, out]``) are transposed,
separate q / k / v projections are concatenated, and the per-head
interleaved fused qkv of BLOOM, NeoX and Megatron is reordered to
contiguous q | k | v.

``convert`` returns ``{port name: Leaf}``: each leaf knows its shape and
builds its tensor when asked, in the file's dtype (a view of the HF
tensor where the layout allows, a new tensor for a concatenation or a
reorder), so the engine casts and places one leaf at a time.
``build_module`` builds on the ``meta`` device by default: the engine
materializes it on the card.

Four JAX policies need models the port does not have; each raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

import math

import torch

A10_MOE = "Queue A10 (MoE)"
A19_ENCODERS = "Queue A19 (BERT, DistilBERT and CLIP models)"


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               f"package yet: see ROADMAP.md {item}")


class Leaf:
    """One port ``state_dict`` entry built on demand from HF tensors."""

    __slots__ = ("shape", "_build")

    def __init__(self, shape, build):
        self.shape = tuple(shape)
        self._build = build

    def build(self):
        return self._build()


def _get(sd, key):
    v = sd[key]
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _same(sd, key):
    """The HF tensor as it is."""
    return Leaf(_get(sd, key).shape, lambda: _get(sd, key))


def _conv1d(sd, key):
    """A ``Conv1D`` weight ``[in, out]`` -> ``[out, in]`` (a view)."""
    return Leaf(_get(sd, key).shape[::-1], lambda: _get(sd, key).t())


def _cat(sd, keys, scales=None):
    """Separate projections (``[out_i, in]`` or biases) stacked along the
    output dim into the fused one; ``scales`` multiplies each part first
    (in float32, the JAX policy's arithmetic)."""
    parts = [_get(sd, k) for k in keys]
    shape = (sum(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:])

    def build():
        ts = [_get(sd, k) for k in keys]
        if scales is not None:
            ts = [t.float() * s if s != 1.0 else t.float()
                  for t, s in zip(ts, scales)]
        return torch.cat(ts, 0)
    return Leaf(shape, build)


def _fused_heads(sd, key, n_head, order):
    """A fused qkv weight ``[3h, in]`` (or bias ``[3h]``) whose output dim
    is laid out as ``order`` over (heads, 3, d) -> contiguous q | k | v.
    ``order="h3d"``: per-head interleaved (BLOOM, NeoX, Megatron v2);
    ``"hd3"``: Megatron checkpoint version 1.0."""
    t0 = _get(sd, key)

    def build():
        t = _get(sd, key)
        rest = tuple(t.shape[1:])
        d = t.shape[0] // (3 * n_head)
        if order == "h3d":
            t = t.reshape(n_head, 3, d, *rest).transpose(0, 1)
        else:
            t = t.reshape(n_head, d, 3, *rest).permute(
                2, 0, 1, *range(3, 3 + len(rest)))
        return t.reshape(3 * n_head * d, *rest)
    return Leaf(t0.shape, build)


def _ln(out, prefix, hf_prefix, sd):
    """A LayerNorm's weight and bias."""
    out[f"{prefix}.weight"] = _same(sd, hf_prefix + ".weight")
    out[f"{prefix}.bias"] = _same(sd, hf_prefix + ".bias")


def _dtype(dtype):
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[dtype]
    return dtype


def _gpt2(cfg_kwargs, dtype, device):
    from deepspeed_tpu_torch.models.gpt2 import GPT2, GPTConfig
    return GPT2(GPTConfig(dtype=_dtype(dtype), **cfg_kwargs), device=device)


def _llama(cfg_kwargs, device):
    from deepspeed_tpu_torch.models.llama import Llama, LlamaConfig
    return Llama(LlamaConfig(**cfg_kwargs), device=device)


class InjectionPolicy:
    """Base policy: subclass per HF ``model_type``."""

    model_type = None

    @classmethod
    def matches(cls, hf_config):
        return getattr(hf_config, "model_type", None) == cls.model_type

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        """The native module equivalent to the HF architecture; ``dtype``
        is the compute dtype (``GPTConfig.dtype``)."""
        raise NotImplementedError

    @classmethod
    def convert(cls, hf_config, sd):
        """HF state dict (name -> tensor or array) -> ``{port state_dict
        name: Leaf}``."""
        raise NotImplementedError


def _gpt_layer(out, i, sd, h, names, qkv, bias=True, ln_2=True):
    """One GPT-2-family block: ``names`` maps ln_1 / ln_2 / proj / fc_in /
    fc_out to HF prefixes (``Linear`` weights), ``qkv`` is the fused
    weight's leaf pair (weight, bias or None); ``bias=False``: an
    unbiased ``proj``; ``ln_2=False``: one LayerNorm (GPT-J)."""
    p = f"h.{i}"
    _ln(out, f"{p}.ln_1", h + names["ln_1"], sd)
    if ln_2:
        _ln(out, f"{p}.ln_2", h + names["ln_2"], sd)
    out[f"{p}.attn.qkv.weight"] = qkv[0]
    if qkv[1] is not None:
        out[f"{p}.attn.qkv.bias"] = qkv[1]
    out[f"{p}.attn.proj.weight"] = _same(sd, h + names["proj"] + ".weight")
    if bias:
        out[f"{p}.attn.proj.bias"] = _same(sd, h + names["proj"] + ".bias")
    for port, hf in (("fc_in", names["fc_in"]), ("fc_out", names["fc_out"])):
        out[f"{p}.mlp.{port}.weight"] = _same(sd, h + hf + ".weight")
        out[f"{p}.mlp.{port}.bias"] = _same(sd, h + hf + ".bias")


class GPT2Policy(InjectionPolicy):
    """HF GPT2LMHeadModel (JAX ``policy.py:46``).  ``Conv1D`` weights are
    ``[in, out]``: every projection is transposed."""

    model_type = "gpt2"

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        return _gpt2(dict(
            vocab_size=c.vocab_size, hidden_size=c.n_embd,
            num_layers=c.n_layer, num_heads=c.n_head,
            max_seq_len=c.n_positions, layer_norm_eps=c.layer_norm_epsilon,
            activation="gelu",            # HF gelu_new: the tanh form
            tie_embeddings=True), dtype, device)

    @classmethod
    def convert(cls, hf_config, sd):
        out = {"wte": _same(sd, "transformer.wte.weight"),
               "wpe": _same(sd, "transformer.wpe.weight")}
        _ln(out, "ln_f", "transformer.ln_f", sd)
        for i in range(hf_config.n_layer):
            h, p = f"transformer.h.{i}.", f"h.{i}"
            _ln(out, f"{p}.ln_1", h + "ln_1", sd)
            _ln(out, f"{p}.ln_2", h + "ln_2", sd)
            for port, hf in (("attn.qkv", "attn.c_attn"),
                             ("attn.proj", "attn.c_proj"),
                             ("mlp.fc_in", "mlp.c_fc"),
                             ("mlp.fc_out", "mlp.c_proj")):
                out[f"{p}.{port}.weight"] = _conv1d(sd, h + hf + ".weight")
                out[f"{p}.{port}.bias"] = _same(sd, h + hf + ".bias")
        return out


class OPTPolicy(InjectionPolicy):
    """HF OPTForCausalLM (JAX ``policy.py:92``): q / k / v fuse into
    ``qkv``; learned positions keep OPT's +2 storage offset."""

    model_type = "opt"

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        if getattr(c, "word_embed_proj_dim", c.hidden_size) != c.hidden_size:
            raise ValueError("OPT variants with word_embed_proj_dim != "
                             "hidden_size (350m) are not supported")
        if not getattr(c, "do_layer_norm_before", True):
            raise ValueError("post-layernorm OPT variants (350m) are not "
                             "supported")
        if c.ffn_dim % c.hidden_size:
            raise ValueError(f"OPT ffn_dim {c.ffn_dim} must be a multiple "
                             f"of hidden_size {c.hidden_size}")
        return _gpt2(dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
            max_seq_len=c.max_position_embeddings,
            mlp_ratio=c.ffn_dim // c.hidden_size, layer_norm_eps=1e-5,
            activation="relu", pos_offset=2, tie_embeddings=True),
            dtype, device)

    @classmethod
    def convert(cls, hf_config, sd):
        d = "model.decoder."
        if d + "final_layer_norm.weight" not in sd and \
                "decoder.embed_tokens.weight" in sd:
            d = "decoder."
        out = {"wte": _same(sd, d + "embed_tokens.weight"),
               "wpe": _same(sd, d + "embed_positions.weight")}
        _ln(out, "ln_f", d + "final_layer_norm", sd)
        names = {"ln_1": "self_attn_layer_norm", "ln_2": "final_layer_norm",
                 "proj": "self_attn.out_proj", "fc_in": "fc1",
                 "fc_out": "fc2"}
        for i in range(hf_config.num_hidden_layers):
            h = f"{d}layers.{i}."
            qkv = (_cat(sd, [h + f"self_attn.{n}_proj.weight"
                             for n in "qkv"]),
                   _cat(sd, [h + f"self_attn.{n}_proj.bias"
                             for n in "qkv"]))
            _gpt_layer(out, i, sd, h, names, qkv)
        return out


class BloomPolicy(InjectionPolicy):
    """HF BloomForCausalLM (JAX ``policy.py:155``): ALiBi, no position
    table, an embedding LayerNorm; the fused ``query_key_value`` is
    per-head interleaved ``(heads, 3, d)`` (``_split_qkv``, ``:178``)."""

    model_type = "bloom"

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        return _gpt2(dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_layers=c.n_layer, num_heads=c.n_head,
            max_seq_len=getattr(c, "seq_length", 2048),
            layer_norm_eps=c.layer_norm_epsilon,
            activation="gelu",            # BloomGelu: the tanh form
            pos_embed="none", use_alibi=True, embed_layernorm=True,
            tie_embeddings=True), dtype, device)

    @classmethod
    def convert(cls, hf_config, sd):
        t = "transformer." if "transformer.word_embeddings.weight" in sd \
            else ""
        out = {"wte": _same(sd, t + "word_embeddings.weight")}
        _ln(out, "ln_embed", t + "word_embeddings_layernorm", sd)
        _ln(out, "ln_f", t + "ln_f", sd)
        names = {"ln_1": "input_layernorm", "ln_2": "post_attention_layernorm",
                 "proj": "self_attention.dense",
                 "fc_in": "mlp.dense_h_to_4h", "fc_out": "mlp.dense_4h_to_h"}
        for i in range(hf_config.n_layer):
            h = f"{t}h.{i}."
            fused = h + "self_attention.query_key_value"
            qkv = (_fused_heads(sd, fused + ".weight", hf_config.n_head,
                                "h3d"),
                   _fused_heads(sd, fused + ".bias", hf_config.n_head,
                                "h3d"))
            _gpt_layer(out, i, sd, h, names, qkv)
        return out


class GPTJPolicy(InjectionPolicy):
    """HF GPTJForCausalLM (JAX ``policy.py:222``): interleaved partial
    rotary, parallel residual off one LayerNorm, unbiased attention, an
    untied ``lm_head`` with a bias."""

    model_type = "gptj"

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        n_inner = getattr(c, "n_inner", None) or 4 * c.n_embd
        if n_inner % c.n_embd:
            raise ValueError(f"GPT-J n_inner {n_inner} must be a multiple "
                             f"of n_embd {c.n_embd}")
        return _gpt2(dict(
            vocab_size=c.vocab_size, hidden_size=c.n_embd,
            num_layers=c.n_layer, num_heads=c.n_head,
            max_seq_len=c.n_positions, mlp_ratio=n_inner // c.n_embd,
            layer_norm_eps=c.layer_norm_epsilon, activation="gelu",
            pos_embed="none", rotary_dim=c.rotary_dim,
            rotary_interleaved=True, parallel_residual=True, single_ln=True,
            attn_bias=False, tie_embeddings=False, lm_head_bias=True),
            dtype, device)

    @classmethod
    def convert(cls, hf_config, sd):
        out = {"wte": _same(sd, "transformer.wte.weight"),
               "lm_head.weight": _same(sd, "lm_head.weight"),
               "lm_head.bias": _same(sd, "lm_head.bias")}
        _ln(out, "ln_f", "transformer.ln_f", sd)
        names = {"ln_1": "ln_1", "proj": "attn.out_proj",
                 "fc_in": "mlp.fc_in", "fc_out": "mlp.fc_out"}
        for i in range(hf_config.n_layer):
            h = f"transformer.h.{i}."
            qkv = (_cat(sd, [h + f"attn.{n}_proj.weight" for n in "qkv"]),
                   None)
            _gpt_layer(out, i, sd, h, names, qkv, bias=False, ln_2=False)
        return out


class GPTNeoXPolicy(InjectionPolicy):
    """HF GPTNeoXForCausalLM (JAX ``policy.py:277``): partial rotate-half
    rotary (``rotary_pct``), parallel residual over two LayerNorms, the
    BLOOM fused-qkv layout, an untied ``embed_out``."""

    model_type = "gpt_neox"

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        head_dim = c.hidden_size // c.num_attention_heads
        if c.intermediate_size % c.hidden_size:
            raise ValueError(f"NeoX intermediate_size {c.intermediate_size} "
                             f"must be a multiple of {c.hidden_size}")
        return _gpt2(dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
            max_seq_len=c.max_position_embeddings,
            mlp_ratio=c.intermediate_size // c.hidden_size,
            layer_norm_eps=c.layer_norm_eps,
            # HF NeoX hidden_act "gelu" is the exact erf form
            activation="gelu_exact" if c.hidden_act == "gelu" else "gelu",
            pos_embed="none", rotary_dim=int(head_dim * c.rotary_pct),
            rope_base=float(getattr(c, "rotary_emb_base", 10000.0)),
            parallel_residual=bool(getattr(c, "use_parallel_residual", True)),
            tie_embeddings=bool(getattr(c, "tie_word_embeddings", False))),
            dtype, device)

    @classmethod
    def convert(cls, hf_config, sd):
        out = {"wte": _same(sd, "gpt_neox.embed_in.weight")}
        _ln(out, "ln_f", "gpt_neox.final_layer_norm", sd)
        if not getattr(hf_config, "tie_word_embeddings", False):
            out["lm_head.weight"] = _same(sd, "embed_out.weight")
        names = {"ln_1": "input_layernorm", "ln_2": "post_attention_layernorm",
                 "proj": "attention.dense", "fc_in": "mlp.dense_h_to_4h",
                 "fc_out": "mlp.dense_4h_to_h"}
        n = hf_config.num_attention_heads
        for i in range(hf_config.num_hidden_layers):
            h = f"gpt_neox.layers.{i}."
            fused = h + "attention.query_key_value"
            qkv = (_fused_heads(sd, fused + ".weight", n, "h3d"),
                   _fused_heads(sd, fused + ".bias", n, "h3d"))
            _gpt_layer(out, i, sd, h, names, qkv)
        return out


class GPTNeoPolicy(InjectionPolicy):
    """HF GPTNeoForCausalLM (JAX ``policy.py:341``): alternating global
    and local layers per ``attention_types``, unbiased q / k / v, a
    biased ``out_proj``.  GPT-Neo scores are not divided by
    sqrt(head_dim), so q is pre-scaled by it (in float32) to cancel the
    module's scaling."""

    model_type = "gpt_neo"

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        inter = getattr(c, "intermediate_size", None) or 4 * c.hidden_size
        if inter % c.hidden_size:
            raise ValueError(f"GPT-Neo intermediate_size {inter} must be a "
                             f"multiple of {c.hidden_size}")
        pattern = []
        for kinds, times in c.attention_types:
            pattern += list(kinds) * times
        windows = tuple(c.window_size if k == "local" else 0
                        for k in pattern)
        return _gpt2(dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_layers=c.num_layers, num_heads=c.num_heads,
            max_seq_len=c.max_position_embeddings,
            mlp_ratio=inter // c.hidden_size,
            layer_norm_eps=c.layer_norm_epsilon, activation="gelu",
            qkv_bias=False, attn_windows=windows, tie_embeddings=True),
            dtype, device)

    @classmethod
    def convert(cls, hf_config, sd):
        out = {"wte": _same(sd, "transformer.wte.weight"),
               "wpe": _same(sd, "transformer.wpe.weight")}
        _ln(out, "ln_f", "transformer.ln_f", sd)
        q_scale = math.sqrt(hf_config.hidden_size // hf_config.num_heads)
        names = {"ln_1": "ln_1", "ln_2": "ln_2",
                 "proj": "attn.attention.out_proj", "fc_in": "mlp.c_fc",
                 "fc_out": "mlp.c_proj"}
        for i in range(hf_config.num_layers):
            h = f"transformer.h.{i}."
            qkv = (_cat(sd, [h + f"attn.attention.{n}_proj.weight"
                             for n in "qkv"],
                        scales=(q_scale, 1.0, 1.0)), None)
            _gpt_layer(out, i, sd, h, names, qkv)
        return out


class MegatronGPT2Policy(InjectionPolicy):
    """Megatron-LM GPT-2 checkpoints (JAX ``policy.py:410``), matched by
    ``model_type`` ``megatron-lm`` / ``megatron_gpt2`` / ``megatron``.
    The fused qkv has three layouts of one shape (``:439-463``): an
    explicit ``megatron_v2`` on the config wins (True: per-head
    ``(heads, 3, d)``, False: contiguous), else ``checkpoint_version``
    from the state dict or the config (< 1.0 contiguous, 1.0 ``(heads,
    d, 3)``, >= 2.0 per-head), else per-head, the reference's default."""

    model_type = "megatron-lm"

    @staticmethod
    def _qkv_layout(hf_config, sd):
        """-> 'contiguous' | 'v1' | 'v2'."""
        v2 = getattr(hf_config, "megatron_v2", None)
        if v2 is not None:
            return "v2" if v2 else "contiguous"
        ver = sd.get("checkpoint_version",
                     getattr(hf_config, "checkpoint_version", None))
        if ver is None:
            return "v2"
        ver = float(ver)
        if ver >= 2.0:
            return "v2"
        return "v1" if ver >= 1.0 else "contiguous"

    @classmethod
    def matches(cls, hf_config):
        return getattr(hf_config, "model_type", None) in (
            "megatron-lm", "megatron_gpt2", "megatron")

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        inter = getattr(c, "ffn_hidden_size", None) or 4 * c.hidden_size
        if inter % c.hidden_size:
            raise ValueError(f"Megatron ffn_hidden_size {inter} must be a "
                             f"multiple of {c.hidden_size}")
        return _gpt2(dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_layers=c.num_layers, num_heads=c.num_attention_heads,
            max_seq_len=c.max_position_embeddings,
            mlp_ratio=inter // c.hidden_size,
            layer_norm_eps=getattr(c, "layernorm_epsilon", 1e-5),
            activation="gelu", tie_embeddings=True), dtype, device)

    @classmethod
    def convert(cls, hf_config, sd):
        lm = "language_model."
        if lm + "embedding.word_embeddings.weight" not in sd and \
                "embedding.word_embeddings.weight" in sd:
            lm = ""
        e, t = lm + "embedding.", lm + "transformer."
        out = {"wte": _same(sd, e + "word_embeddings.weight"),
               "wpe": _same(sd, e + "position_embeddings.weight")}
        _ln(out, "ln_f", t + "final_layernorm", sd)
        layout = cls._qkv_layout(hf_config, sd)
        n = hf_config.num_attention_heads
        names = {"ln_1": "input_layernorm", "ln_2": "post_attention_layernorm",
                 "proj": "attention.dense", "fc_in": "mlp.dense_h_to_4h",
                 "fc_out": "mlp.dense_4h_to_h"}
        for i in range(hf_config.num_layers):
            h = f"{t}layers.{i}."
            fused = h + "attention.query_key_value"
            if layout == "contiguous":
                qkv = (_same(sd, fused + ".weight"),
                       _same(sd, fused + ".bias"))
            else:
                order = "h3d" if layout == "v2" else "hd3"
                qkv = (_fused_heads(sd, fused + ".weight", n, order),
                       _fused_heads(sd, fused + ".bias", n, order))
            _gpt_layer(out, i, sd, h, names, qkv)
        return out


class MegatronGPTMoEPolicy(MegatronGPT2Policy):
    """Megatron-DeepSpeed MoE checkpoints (JAX ``policy.py:538``): the
    port has no MoE model yet."""

    model_type = "megatron-moe"

    @classmethod
    def matches(cls, hf_config):
        return getattr(hf_config, "model_type", None) in (
            "megatron-moe", "megatron_gpt_moe", "megatron-deepspeed-moe")

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        raise _unported("Megatron MoE ingestion (MegatronGPTMoEPolicy)",
                        A10_MOE)

    @classmethod
    def convert(cls, hf_config, sd):
        raise _unported("Megatron MoE ingestion (MegatronGPTMoEPolicy)",
                        A10_MOE)


class _EncoderPolicy(InjectionPolicy):
    """An encoder family the port has no model for (JAX ``CLIPPolicy``
    ``:644``, ``DistilBertPolicy`` ``:865``, ``BertPolicy`` ``:934``)."""

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        raise _unported(f"{cls.__name__} ingestion", A19_ENCODERS)

    @classmethod
    def convert(cls, hf_config, sd):
        raise _unported(f"{cls.__name__} ingestion", A19_ENCODERS)


class CLIPPolicy(_EncoderPolicy):
    model_type = "clip_text_model"

    @classmethod
    def matches(cls, hf_config):
        return getattr(hf_config, "model_type", None) in (
            "clip_text_model", "clip")


class DistilBertPolicy(_EncoderPolicy):
    model_type = "distilbert"


class BertPolicy(_EncoderPolicy):
    model_type = "bert"


def _llama_layers(out, sd, prefix, n_layers):
    for i in range(n_layers):
        h, p = f"{prefix}layers.{i}.", f"layers.{i}"
        out[f"{p}.input_norm.scale"] = _same(sd, h + "input_layernorm.weight")
        out[f"{p}.post_attn_norm.scale"] = _same(
            sd, h + "post_attention_layernorm.weight")
        for port, hf in (("attn.wq", "self_attn.q_proj"),
                         ("attn.wk", "self_attn.k_proj"),
                         ("attn.wv", "self_attn.v_proj"),
                         ("attn.wo", "self_attn.o_proj"),
                         ("mlp.w_gate", "mlp.gate_proj"),
                         ("mlp.w_up", "mlp.up_proj"),
                         ("mlp.w_down", "mlp.down_proj")):
            out[f"{p}.{port}.weight"] = _same(sd, h + hf + ".weight")


class LlamaPolicy(InjectionPolicy):
    """HF LlamaForCausalLM (JAX ``policy.py:706``).  HF Llama's q / k are
    rotate-half, the port's rotary, so every weight passes as it is."""

    model_type = "llama"

    @classmethod
    def build_module(cls, hf_config, dtype=None, device="meta"):
        c = hf_config
        return _llama(dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
            num_kv_heads=getattr(c, "num_key_value_heads", None)
            or c.num_attention_heads,
            intermediate_size=c.intermediate_size,
            max_seq_len=c.max_position_embeddings,
            rope_base=float(getattr(c, "rope_theta", 10000.0)),
            rms_eps=c.rms_norm_eps,
            tie_embeddings=bool(getattr(c, "tie_word_embeddings", False))),
            device)

    @classmethod
    def convert(cls, hf_config, sd):
        out = {"embed_tokens.weight": _same(sd, "model.embed_tokens.weight"),
               "norm.scale": _same(sd, "model.norm.weight")}
        if not getattr(hf_config, "tie_word_embeddings", False):
            out["lm_head.weight"] = _same(sd, "lm_head.weight")
        _llama_layers(out, sd, "model.", hf_config.num_hidden_layers)
        return out


class AutoTPPolicy(InjectionPolicy):
    """The structural fallback for an unknown decoder (JAX ``policy.py:
    756-862``): a llama-shaped state dict (per-layer q/k/v/o, gate/up/down,
    RMS norms) ingests as ``Llama`` whatever its HF class.  Biased
    projections, ``sliding_window`` and ``rope_scaling`` are refused:
    the plain llama module cannot honour them."""

    model_type = None

    _LAYER_KEYS = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                   "self_attn.v_proj.weight", "self_attn.o_proj.weight",
                   "mlp.gate_proj.weight", "mlp.up_proj.weight",
                   "mlp.down_proj.weight", "input_layernorm.weight",
                   "post_attention_layernorm.weight")

    @classmethod
    def discover(cls, sd):
        """The decoder prefix (e.g. ``'model.'``) of a llama-shaped state
        dict, else None."""
        tail = "layers.0.self_attn.q_proj.weight"
        for key in sd:
            if key.endswith(tail):
                prefix = key[:-len(tail)]
                if all(f"{prefix}layers.0.{k}" in sd
                       for k in cls._LAYER_KEYS) and \
                        f"{prefix}embed_tokens.weight" in sd and \
                        f"{prefix}norm.weight" in sd:
                    return prefix
        return None

    @classmethod
    def ingest(cls, hf_config, sd, dtype=None, device="meta"):
        """(module, {port name: Leaf}) of a discovered llama-shaped
        decoder."""
        prefix = cls.discover(sd)
        if prefix is None:
            raise ValueError(
                "AutoTP fallback: state dict is not a recognizable "
                "llama-shaped decoder (need per-layer "
                "self_attn.{q,k,v,o}_proj + mlp.{gate,up,down}_proj + "
                "input/post_attention layernorms)")
        biased = [k for k in sd
                  if "layers.0." in k and k.endswith("proj.bias")]
        if biased:
            raise ValueError(
                f"AutoTP fallback: biased projections {biased[:3]} need "
                "a hand-written policy (the native llama module is "
                "bias-free)")
        c = hf_config
        if getattr(c, "sliding_window", None):
            raise ValueError(
                "AutoTP fallback: config.sliding_window="
                f"{c.sliding_window} — windowed attention needs a "
                "hand-written policy (set sliding_window=None only if "
                "your sequences never exceed the window)")
        if getattr(c, "rope_scaling", None):
            raise ValueError("AutoTP fallback: config.rope_scaling is set — "
                             "scaled rope needs a hand-written policy")
        start = len(prefix) + len("layers.")
        n_layers = 1 + max(int(k[start:].split(".")[0])
                           for k in sd if k.startswith(prefix + "layers."))
        embed = _get(sd, prefix + "embed_tokens.weight")
        hidden = embed.shape[1]
        n_heads = c.num_attention_heads
        kv_dim = _get(sd, prefix + "layers.0.self_attn.k_proj.weight").shape[0]
        tie = bool(getattr(c, "tie_word_embeddings", False)) or \
            "lm_head.weight" not in sd
        module = _llama(dict(
            vocab_size=embed.shape[0], hidden_size=hidden,
            num_layers=n_layers, num_heads=n_heads,
            num_kv_heads=kv_dim // (hidden // n_heads),
            intermediate_size=_get(
                sd, prefix + "layers.0.mlp.gate_proj.weight").shape[0],
            max_seq_len=getattr(c, "max_position_embeddings", 2048),
            rope_base=float(getattr(c, "rope_theta", 10000.0)),
            rms_eps=getattr(c, "rms_norm_eps", 1e-6), tie_embeddings=tie),
            device)
        out = {"embed_tokens.weight": _same(sd, prefix + "embed_tokens.weight"),
               "norm.scale": _same(sd, prefix + "norm.weight")}
        if not tie:
            out["lm_head.weight"] = _same(sd, "lm_head.weight")
        _llama_layers(out, sd, prefix, n_layers)
        return module, out
