"""HF model configs without ``transformers``.

:func:`load_hf_config` turns a ``save_pretrained`` directory's
``config.json`` (or its path, a dict, or a ``transformers`` config
instance, by duck typing: ``model_type`` plus attributes) into an
:class:`HFConfig`, an attribute object the ingestion policies read as
they would read the ``transformers`` class.  Two things the class does
are done here:

* **Aliases.**  Each family's ``attribute_map`` (GPT-2's ``hidden_size``
  -> ``n_embd``, BLOOM's ``num_hidden_layers`` -> ``n_layer``, ...)
  resolves both ways.
* **Defaults.**  A key missing from the file takes the family class's
  ``__init__`` default, then ``PretrainedConfig``'s: ``save_pretrained``
  writes through ``to_diff_dict``, which drops base-class fields at their
  default (GPT-2's file has no ``tie_word_embeddings``; it is True), and
  a hand-written file may leave out anything.  Values the class derives
  in ``__init__`` (Llama's ``num_key_value_heads`` from the head count,
  OPT's ``word_embed_proj_dim`` from the width) are derived the same way.

The tables cover the keys the policies of ``module_inject/policy.py``
read, at the defaults of ``transformers`` 4.57.
"""

import json
import os

# the family class's attribute_map: canonical name -> stored name
ATTRIBUTE_MAPS = {
    "gpt2": {"hidden_size": "n_embd", "max_position_embeddings":
             "n_positions", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "gptj": {"hidden_size": "n_embd", "max_position_embeddings":
             "n_positions", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "bloom": {"num_hidden_layers": "n_layer", "num_attention_heads":
              "n_head"},
    "gpt_neo": {"num_attention_heads": "num_heads", "num_hidden_layers":
                "num_layers"},
}

# PretrainedConfig's own default of the one base-class key a policy reads
BASE_DEFAULTS = {"tie_word_embeddings": True}

# each family class's __init__ defaults of the keys the policies read
# (transformers 4.57)
FAMILY_DEFAULTS = {
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12, n_inner=None, layer_norm_epsilon=1e-5),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12,
                ffn_dim=3072, max_position_embeddings=2048,
                do_layer_norm_before=True, word_embed_proj_dim=None,
                num_attention_heads=12),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5),
    "gptj": dict(vocab_size=50400, n_positions=2048, n_embd=4096,
                 n_layer=28, n_head=16, rotary_dim=64, n_inner=None,
                 layer_norm_epsilon=1e-5, tie_word_embeddings=False),
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144,
                     num_hidden_layers=44, num_attention_heads=64,
                     intermediate_size=24576, hidden_act="gelu",
                     rotary_pct=0.25, rotary_emb_base=10000,
                     max_position_embeddings=2048, layer_norm_eps=1e-5,
                     tie_word_embeddings=False, use_parallel_residual=True),
    "gpt_neo": dict(vocab_size=50257, max_position_embeddings=2048,
                    hidden_size=2048, num_layers=24,
                    attention_types=[[["global", "local"], 12]],
                    num_heads=16, intermediate_size=None, window_size=256,
                    layer_norm_epsilon=1e-5),
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=None, max_position_embeddings=2048,
                  rms_norm_eps=1e-6, tie_word_embeddings=False,
                  rope_theta=10000.0, rope_scaling=None, head_dim=None),
    # the AutoTP fallback's most common guest
    "mistral": dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=131072,
                    rms_norm_eps=1e-6, tie_word_embeddings=False,
                    rope_theta=10000.0, sliding_window=4096),
}


def _derived(model_type, values):
    """The values the family class computes in ``__init__``."""
    out = {}
    if model_type in ("llama", "mistral"):
        heads = values.get("num_attention_heads")
        if values.get("num_key_value_heads") is None and heads:
            out["num_key_value_heads"] = heads
        if values.get("head_dim") is None and heads:
            out["head_dim"] = values["hidden_size"] // heads
    if model_type == "opt" and values.get("word_embed_proj_dim") is None:
        out["word_embed_proj_dim"] = values.get("hidden_size")
    return out


class HFConfig:
    """An HF config as attributes: stored keys, then the family's aliases,
    then the family's and the base class's defaults.  ``source`` (a
    ``transformers`` config or any object) is asked last, so a duck-typed
    config keeps every attribute it has."""

    def __init__(self, values, source=None):
        values = dict(values)
        model_type = values.get("model_type") or getattr(source, "model_type",
                                                         None)
        values["model_type"] = model_type
        aliases = ATTRIBUTE_MAPS.get(model_type, {})
        for canon, stored in aliases.items():
            # a file may spell either name; store under the class's
            if canon in values and stored not in values:
                values[stored] = values.pop(canon)
        full = {**BASE_DEFAULTS, **FAMILY_DEFAULTS.get(model_type, {}),
                **values}
        full.update(_derived(model_type, full))
        self.__dict__["_values"] = full
        self.__dict__["_aliases"] = aliases
        self.__dict__["_source"] = source

    def __getattr__(self, name):
        values = self.__dict__["_values"]
        if name in values:
            return values[name]
        stored = self.__dict__["_aliases"].get(name)
        if stored is not None and stored in values:
            return values[stored]
        source = self.__dict__["_source"]
        if source is not None and not name.startswith("__"):
            return getattr(source, name)
        raise AttributeError(f"HF config of model_type "
                             f"{values.get('model_type')!r} has no {name!r}")

    def __repr__(self):
        return f"HFConfig({self.__dict__['_values']!r})"


def load_hf_config(config):
    """An :class:`HFConfig` from a ``save_pretrained`` directory, a
    ``config.json`` path, a dict, an :class:`HFConfig` or a config object
    (``transformers``' or any with ``model_type``)."""
    if isinstance(config, HFConfig):
        return config
    if isinstance(config, (str, os.PathLike)):
        path = os.fspath(config)
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return HFConfig(json.load(f))
    if isinstance(config, dict):
        return HFConfig(config)
    if not hasattr(config, "model_type"):
        raise ValueError(f"not an HF config (no model_type): "
                         f"{type(config).__name__}")
    if hasattr(config, "to_dict"):
        values = config.to_dict()
    else:
        values = {k: v for k, v in vars(config).items()
                  if not k.startswith("_")}
    return HFConfig(values, source=config)
