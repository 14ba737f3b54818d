"""HF ingestion in the port (``deepspeed_tpu_torch.module_inject``) held
against the HF models themselves and the JAX package's ``from_hf``.

Models are built from configs written here (no downloads) with seeded
random weights, as ``tests/unit/test_module_inject.py`` builds them.
Oracles, fp32, ``rtol=atol=2e-4`` (the JAX tests' ``TOL``): each policy's
logits against the HF forward and the JAX ``init_inference(hf)``
forward; greedy ``generate()`` token-exact against the JAX engine's;
``save_pretrained`` directories (safetensors, sharded safetensors,
``.bin``, bf16) ingest to the same weights as the instance; the config
reader equals ``AutoConfig`` on the attributes the policies read; a
directory ingests in a process where ``transformers`` and
``safetensors`` cannot be imported.  A tied ``llama_tiny`` (the
``tie_embeddings`` repair) is held against the JAX module: logits, the
dense-cache ``generate()`` and paged serving, float and int8 weights.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

os.environ.setdefault("USE_TF", "0")         # transformers without TF

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.module_inject import policy as jpolicy  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.module_inject import (  # noqa: E402
    from_hf, policy_for)
from deepspeed_tpu_torch.module_inject import policy as tpolicy  # noqa: E402
from deepspeed_tpu_torch.module_inject.hf_config import (  # noqa: E402
    load_hf_config)
from deepspeed_tpu_torch.module_inject.hf_weights import (  # noqa: E402
    read_safetensors, save_hf_dir, write_safetensors)
from deepspeed_tpu_torch.serving import ServingScheduler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
JAX_MESH = {"data": 1, "model": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_model(family):
    """A seeded random HF model of ``family`` at test size."""
    torch.manual_seed(0)
    t = transformers
    if family == "gpt2":
        return t.GPT2LMHeadModel(t.GPT2Config(
            vocab_size=128, n_positions=64, n_embd=48, n_layer=2, n_head=4))
    if family == "opt":
        return t.OPTForCausalLM(t.OPTConfig(
            vocab_size=128, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, ffn_dim=192, max_position_embeddings=64,
            word_embed_proj_dim=48))
    if family == "bloom":
        return t.BloomForCausalLM(t.BloomConfig(
            vocab_size=128, hidden_size=48, n_layer=2, n_head=4))
    if family == "gptj":
        return t.GPTJForCausalLM(t.GPTJConfig(
            vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            rotary_dim=8))
    if family in ("neox", "neox_serial"):
        return t.GPTNeoXForCausalLM(t.GPTNeoXConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=64,
            rotary_pct=0.25 if family == "neox" else 1.0,
            use_parallel_residual=family == "neox"))
    if family == "neo":
        return t.GPTNeoForCausalLM(t.GPTNeoConfig(
            vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            attention_types=[[["global", "local"], 1]], window_size=4,
            max_position_embeddings=64, intermediate_size=256))
    if family in ("llama", "llama_tied"):
        return t.LlamaForCausalLM(t.LlamaConfig(
            vocab_size=128, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, max_position_embeddings=64,
            tie_word_embeddings=family == "llama_tied"))
    if family == "mistral":                    # the AutoTP fallback
        return t.MistralForCausalLM(t.MistralConfig(
            vocab_size=128, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, max_position_embeddings=64,
            sliding_window=None))
    raise ValueError(family)


FAMILIES = ["gpt2", "opt", "bloom", "gptj", "neox", "neox_serial", "neo",
            "llama", "llama_tied", "mistral"]
GENERATED = ["gpt2", "opt", "bloom", "gptj", "neox", "llama", "llama_tied"]


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(0).integers(3, 120, (2, 12)).astype(
        np.int32)


def hf_logits(model, ids):
    model.eval()
    with torch.no_grad():
        return model(torch.tensor(ids, dtype=torch.long)).logits.numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_policy_logits_and_greedy_tokens_match_hf_and_jax(family, ids):
    """The port's logits equal the HF forward's and the JAX ``from_hf``
    engine's; greedy ``generate()`` (dense cache, 8 new tokens, two rows
    batched) equals the JAX engine's token for token."""
    hf = hf_model(family)
    teng = deepspeed_tpu_torch.init_inference(hf, dtype="float32",
                                              kv_cache_dtype="float32",
                                              device="cpu")
    jeng = deepspeed_tpu.init_inference(hf, dtype="float32",
                                        kv_cache_dtype="float32",
                                        mesh=JAX_MESH)
    got = teng.forward(ids).numpy()
    np.testing.assert_allclose(got, hf_logits(hf, ids), **TOL)
    np.testing.assert_allclose(got, np.asarray(jeng.forward(ids)), **TOL)
    if family in GENERATED:
        prompt = ids[:, :6]
        np.testing.assert_array_equal(
            teng.generate(prompt, max_new_tokens=8),
            np.asarray(jeng.generate(prompt, max_new_tokens=8)))


def _megatron_sd(hsd, n_head, h, layout):
    """An HF GPT-2 state dict in the Megatron-LM layout, fused qkv as
    ``layout`` ("v2": (heads, 3, d), "v1": (heads, d, 3), "contiguous")."""
    hd = h // n_head

    def qkv(w, b):
        w = w.T                                   # [3h, in]
        if layout == "contiguous":
            return w, b
        q, k, v = np.split(w, 3, axis=0)
        bq, bk, bv = np.split(b, 3)
        axis = 1 if layout == "v2" else 2
        w3 = np.stack([x.reshape(n_head, hd, h) for x in (q, k, v)],
                      axis=axis)
        b3 = np.stack([x.reshape(n_head, hd) for x in (bq, bk, bv)],
                      axis=axis)
        return w3.reshape(3 * h, h), b3.reshape(3 * h)

    lm = "language_model."
    sd = {lm + "embedding.word_embeddings.weight":
          hsd["transformer.wte.weight"],
          lm + "embedding.position_embeddings.weight":
          hsd["transformer.wpe.weight"],
          lm + "transformer.final_layernorm.weight":
          hsd["transformer.ln_f.weight"],
          lm + "transformer.final_layernorm.bias":
          hsd["transformer.ln_f.bias"]}
    if layout != "v2":
        sd["checkpoint_version"] = 0.0 if layout == "contiguous" else 1.0
    for i in range(2):
        src, dst = f"transformer.h.{i}.", f"{lm}transformer.layers.{i}."
        w, b = qkv(hsd[src + "attn.c_attn.weight"],
                   hsd[src + "attn.c_attn.bias"])
        sd[dst + "attention.query_key_value.weight"] = w
        sd[dst + "attention.query_key_value.bias"] = b
        for a, c in (("input_layernorm", "ln_1"),
                     ("post_attention_layernorm", "ln_2")):
            sd[dst + a + ".weight"] = hsd[src + c + ".weight"]
            sd[dst + a + ".bias"] = hsd[src + c + ".bias"]
        for a, c in (("attention.dense", "attn.c_proj"),
                     ("mlp.dense_h_to_4h", "mlp.c_fc"),
                     ("mlp.dense_4h_to_h", "mlp.c_proj")):
            sd[dst + a + ".weight"] = hsd[src + c + ".weight"].T
            sd[dst + a + ".bias"] = hsd[src + c + ".bias"]
    return sd


@pytest.mark.parametrize("layout", ["v2", "v1", "contiguous"])
def test_megatron_fused_qkv_layouts(layout, ids):
    """The three Megatron fused-qkv layouts, told apart by
    ``checkpoint_version`` (absent: v2), give the HF model's logits and
    the JAX policy's tree."""
    hf = hf_model("gpt2")
    hsd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    sd = _megatron_sd(hsd, 4, 48, layout)
    cfg = SimpleNamespace(
        model_type="megatron-lm", vocab_size=128, hidden_size=48,
        num_layers=2, num_attention_heads=4, max_position_embeddings=64,
        ffn_hidden_size=192, layernorm_epsilon=1e-5)
    pol = policy_for(cfg)
    assert pol is tpolicy.MegatronGPT2Policy
    assert pol._qkv_layout(cfg, sd) == layout
    module, state = pol.build_module(cfg), pol.convert(cfg, sd)
    eng = deepspeed_tpu_torch.init_inference(
        module, dtype="float32", device="cpu",
        params={k: leaf.build() for k, leaf in state.items()})
    np.testing.assert_allclose(eng.forward(ids).numpy(), hf_logits(hf, ids),
                               **TOL)
    jtree = jpolicy.MegatronGPT2Policy.convert(cfg, sd)
    np.testing.assert_array_equal(
        eng.module.h[1].attn.qkv.weight.numpy(),
        np.asarray(jtree["h_1"]["attn"]["qkv"]["kernel"]).T)


def _dir_variants(hf, tmp):
    """``save_pretrained`` directories of one model: safetensors, sharded
    safetensors, ``.bin``, and a bf16 copy written by this package."""
    out = {}
    for name, kw in (("safetensors", {}),
                     ("sharded", {"max_shard_size": "20KB"}),
                     ("bin", {"safe_serialization": False})):
        path = os.path.join(tmp, name)
        hf.save_pretrained(path, **kw)
        out[name] = path
    bf16 = os.path.join(tmp, "bf16")
    save_hf_dir(bf16, hf.config.to_dict(),
                {k: v.to(torch.bfloat16) for k, v in hf.state_dict().items()
                 if k != "lm_head.weight" or
                 not hf.config.tie_word_embeddings}, shards=2)
    out["bf16"] = bf16
    return out


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_directories_ingest_the_instance_weights(family, tmp_path, ids):
    """Every layout ingests to the weights of the instance, bit for bit
    (bf16: the bf16 values, cast back to fp32); the sharded one names
    more than one file; ``transformers`` reads this package's safetensors
    writer."""
    hf = hf_model(family)
    dirs = _dir_variants(hf, str(tmp_path))
    assert len({f for f in os.listdir(dirs["sharded"])
                if f.endswith(".safetensors")}) > 1
    want = deepspeed_tpu_torch.init_inference(
        hf, dtype="float32", device="cpu").module.state_dict()
    for name, path in dirs.items():
        got = deepspeed_tpu_torch.init_inference(
            path, dtype="float32", device="cpu").module.state_dict()
        assert set(got) == set(want), name
        for k in want:
            ref = want[k].to(torch.bfloat16).float() if name == "bf16" \
                else want[k]
            assert torch.equal(got[k], ref), (name, k)
    back = type(hf).from_pretrained(dirs["bf16"], dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        back.state_dict()["model.norm.weight" if family == "llama"
                          else "transformer.ln_f.weight"].float().numpy(),
        got["norm.scale" if family == "llama" else "ln_f.weight"].numpy())


def test_safetensors_reader_keeps_file_dtypes_and_maps_views(tmp_path):
    """Every dtype round-trips bit for bit in its own dtype; leaves are
    views of a copy-on-write mapping of the file."""
    g = torch.Generator().manual_seed(1)
    tensors = {"f32": torch.randn(3, 5, generator=g),
               "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
               "f16": torch.randn(2, 3, generator=g).half(),
               "i8": torch.randint(-128, 127, (9,), dtype=torch.int8),
               "i64": torch.arange(3), "scalar": torch.tensor(2.5),
               "fp8": torch.randn(4, generator=g).to(torch.float8_e4m3fn)}
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, tensors)
    got = read_safetensors(path)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           t.reshape(-1).view(torch.uint8))
    # a leaf is the file's bytes: a write to the copy-on-write mapping
    # changes neither the file nor a second read
    got["f32"].zero_()
    assert torch.equal(read_safetensors(path)["f32"], tensors["f32"])


HF_ATTRS = {
    "gpt2": ["n_embd", "hidden_size", "n_layer", "num_hidden_layers",
             "n_head", "n_positions", "layer_norm_epsilon", "n_inner",
             "tie_word_embeddings", "vocab_size"],
    "opt": ["hidden_size", "ffn_dim", "word_embed_proj_dim",
            "do_layer_norm_before", "max_position_embeddings",
            "tie_word_embeddings"],
    "bloom": ["hidden_size", "n_layer", "num_hidden_layers", "n_head",
              "layer_norm_epsilon", "tie_word_embeddings"],
    "gptj": ["n_embd", "rotary_dim", "n_inner", "n_positions",
             "tie_word_embeddings", "layer_norm_epsilon"],
    "neox": ["rotary_pct", "rotary_emb_base", "hidden_act",
             "use_parallel_residual", "tie_word_embeddings",
             "layer_norm_eps", "intermediate_size"],
    "neo": ["num_layers", "num_heads", "attention_types", "window_size",
            "intermediate_size", "hidden_size", "tie_word_embeddings"],
    "llama_tied": ["num_key_value_heads", "rope_theta", "rms_norm_eps",
                   "tie_word_embeddings", "max_position_embeddings",
                   "rope_scaling", "head_dim"],
    "mistral": ["sliding_window", "rope_theta", "num_key_value_heads",
                "tie_word_embeddings"],
}


@pytest.mark.parametrize("family", list(HF_ATTRS))
def test_config_reader_matches_autoconfig(family, tmp_path):
    """On a ``save_pretrained`` file (base-class defaults left out) and on
    the same file stripped to ``model_type`` plus the shapes (every other
    key from the family's defaults), the reader answers as ``AutoConfig``
    does."""
    hf = hf_model(family)
    hf.config.save_pretrained(str(tmp_path))
    with open(tmp_path / "config.json") as f:
        written = json.load(f)
    assert "tie_word_embeddings" not in written or family in (
        "llama_tied", "gptj", "neox", "mistral")
    ours = load_hf_config(str(tmp_path))
    theirs = transformers.AutoConfig.from_pretrained(str(tmp_path))
    for attr in HF_ATTRS[family]:
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    bare = tmp_path / "bare"
    bare.mkdir()
    keep = {"model_type", "vocab_size"}
    (bare / "config.json").write_text(json.dumps(
        {k: v for k, v in written.items() if k in keep}))
    ours = load_hf_config(str(bare))
    theirs = transformers.AutoConfig.from_pretrained(str(bare))
    for attr in HF_ATTRS[family]:
        assert getattr(ours, attr) == getattr(theirs, attr), attr


def test_directory_ingests_without_transformers_or_safetensors(tmp_path,
                                                               ids):
    """A child process that cannot import ``transformers`` or
    ``safetensors`` ingests a sharded safetensors directory and a ``.bin``
    one to the HF model's logits."""
    hf = hf_model("neox")
    hf.save_pretrained(str(tmp_path / "st"), max_shard_size="40KB")
    hf.save_pretrained(str(tmp_path / "bin"), safe_serialization=False)
    np.save(tmp_path / "ids.npy", ids)
    np.save(tmp_path / "want.npy", hf_logits(hf, ids))
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "import numpy as np, torch\n"
        "import deepspeed_tpu_torch as dt\n"
        f"d = {str(tmp_path)!r}\n"
        "ids, want = np.load(d + '/ids.npy'), np.load(d + '/want.npy')\n"
        "for sub in ('st', 'bin'):\n"
        "    eng = dt.init_inference(d + '/' + sub, dtype='float32',\n"
        "                            device='cpu')\n"
        "    np.testing.assert_allclose(eng.forward(ids).numpy(), want,\n"
        "                               rtol=2e-4, atol=2e-4)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'deepspeed_tpu') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_autotp_fallback_refusals_and_unported_families():
    """AutoTP refuses biased projections, sliding windows and scaled rope;
    the MoE and encoder policies name their ROADMAP items; an unknown
    architecture that is not llama-shaped raises."""
    hf = hf_model("mistral")
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    cfg = load_hf_config(hf.config)
    with pytest.raises(ValueError, match="no ingestion policy"):
        policy_for(cfg)
    assert tpolicy.AutoTPPolicy.discover(sd) == "model."
    biased = dict(sd, **{"model.layers.0.self_attn.q_proj.bias":
                         torch.zeros(48)})
    for c, state, match in ((cfg, biased, "biased"),
                            (load_hf_config(dict(hf.config.to_dict(),
                                                 sliding_window=8)),
                             sd, "sliding_window"),
                            (load_hf_config(dict(
                                hf.config.to_dict(),
                                rope_scaling={"type": "linear",
                                              "factor": 2.0})),
                             sd, "rope_scaling")):
        with pytest.raises(ValueError, match=match):
            tpolicy.AutoTPPolicy.ingest(c, state)
    for model_type, item in (("megatron-moe", "A10"), ("bert", "A19"),
                             ("distilbert", "A19"), ("clip", "A19")):
        pol = policy_for(SimpleNamespace(model_type=model_type))
        with pytest.raises(NotImplementedError, match=item):
            pol.build_module(SimpleNamespace(model_type=model_type))
    bert = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64))
    with pytest.raises(NotImplementedError, match="A19"):
        deepspeed_tpu_torch.init_inference(bert, device="cpu")
    with pytest.raises(ValueError, match="no ingestion policy"):
        from_hf(transformers.MambaForCausalLM(transformers.MambaConfig(
            vocab_size=64, hidden_size=16, num_hidden_layers=1)))
    with pytest.raises(NotImplementedError, match="from_hf"):
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(2, 2),
                                           device="cpu")


def test_structure_check_names_missing_and_misshapen_leaves():
    hf = hf_model("llama")
    cfg = hf.config.to_dict()
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    with pytest.raises(KeyError):
        from_hf(hf, hf_config=dict(cfg, num_hidden_layers=3))
    short = dict(cfg, intermediate_size=64)
    with pytest.raises(ValueError, match="shape mismatch"):
        from_hf(hf, hf_config=short)
    module, state = from_hf(hf)
    assert next(module.parameters()).is_meta
    assert state.shape("lm_head.weight") == (128, 48)
    assert torch.equal(state["layers.1.mlp.w_up.weight"],
                       sd["model.layers.1.mlp.up_proj.weight"])


# ------------------------------------------------ tied llama (the repair)


@pytest.fixture(scope="module")
def tied_llama():
    jcfg = jllama.llama_tiny(tie_embeddings=True)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, jax.device_get(
        jllama.Llama(jcfg).init(jax.random.PRNGKey(4), ids)["params"]))
    params = jax.tree.map(lambda x: x.value if hasattr(x, "value") else x,
                          params, is_leaf=lambda x: hasattr(x, "value"))
    assert "lm_head" not in params
    return jcfg, params


@pytest.mark.parametrize("quant", [False, True])
def test_tied_llama_matches_the_jax_module(tied_llama, quant):
    """Logits (no cache), the dense-cache ``generate()`` and paged serving
    of a tied ``llama_tiny`` against the JAX model and engine, with fp32
    and int8 (group 32) weights."""
    jcfg, params = tied_llama
    kw = dict(dtype="float32", kv_cache_dtype="float32")
    if quant:
        kw["quant"] = {"enabled": True, "group_size": 32}
    teng = deepspeed_tpu_torch.init_inference(
        tllama.Llama(tllama.llama_tiny(tie_embeddings=True)), device="cpu",
        **kw).set_params(tllama.llama_params_from_jax(params))
    assert not hasattr(teng.module, "lm_head")
    jeng = deepspeed_tpu.init_inference(
        model=jllama.Llama(jcfg), mesh=JAX_MESH, **kw).set_params(params)
    ids = np.random.default_rng(2).integers(0, 256, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(teng.forward(ids).numpy(),
                               np.asarray(jeng.forward(ids)), atol=1e-4,
                               rtol=1e-4)
    want = np.asarray(jeng.generate(ids, max_new_tokens=10))
    np.testing.assert_array_equal(teng.generate(ids, max_new_tokens=10),
                                  want)
    sched = ServingScheduler(teng, num_slots=2, num_pages=8, page_size=8,
                             max_pages_per_slot=4, prefill_chunk=8)
    reqs = [sched.submit(p, max_new_tokens=10) for p in ids]
    got = sched.run()
    for r, w in zip(reqs, want):
        assert got[r.rid] == [int(t) for t in w[ids.shape[1]:]]
    assert sched.kv.pool.pages_in_use == 0
    if quant:   # the JAX engine's QTensor tree (no lm_head) carries over
        other = deepspeed_tpu_torch.init_inference(
            tllama.Llama(tllama.llama_tiny(tie_embeddings=True)),
            device="cpu", **kw)
        tllama.load_quantized_params_from_jax(other.module, jeng.params)
        for (name, a), (_, b) in zip(other.module.state_dict().items(),
                                     teng.module.state_dict().items()):
            assert torch.equal(a, b), name
