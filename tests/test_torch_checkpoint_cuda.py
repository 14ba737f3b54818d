"""HF ingestion and training checkpoints on the card: a bf16 safetensors
directory (sharded, written by this package) read onto the card bit for
bit in fp32 and bf16 engines, served token-exact against ``generate()``
through graph serving with ``paged_decode_fwd`` launched; a bf16 GPT-2
training run saved, resumed in a fresh engine and stepped again equal
to the uninterrupted run bit for bit (losses, masters, moments), with
the flash kernels launched on both sides and an async save's files
holding the pre-step masters.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; run them on the card with ``python -m pytest
tests/test_torch_checkpoint_cuda.py -m cuda``.
"""

import copy

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.module_inject.hf_weights import save_hf_dir
from deepspeed_tpu_torch.ops.attention import decode as tdec
from deepspeed_tpu_torch.ops.attention import flash as tfl
from deepspeed_tpu_torch.serving import ServingScheduler

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _llama_dir(path, layers=2, hidden=256, heads=4, vocab=512):
    g = torch.Generator().manual_seed(0)

    def w(*shape):
        return (torch.randn(*shape, generator=g) * 0.05).to(torch.bfloat16)
    sd = {"model.embed_tokens.weight": w(vocab, hidden),
          "model.norm.weight": 1 + w(hidden), "lm_head.weight": w(vocab,
                                                                   hidden)}
    for i in range(layers):
        h = f"model.layers.{i}."
        sd[h + "input_layernorm.weight"] = 1 + w(hidden)
        sd[h + "post_attention_layernorm.weight"] = 1 + w(hidden)
        for n in ("q", "k", "v", "o"):
            sd[h + f"self_attn.{n}_proj.weight"] = w(hidden, hidden)
        sd[h + "mlp.gate_proj.weight"] = w(512, hidden)
        sd[h + "mlp.up_proj.weight"] = w(512, hidden)
        sd[h + "mlp.down_proj.weight"] = w(hidden, 512)
    cfg = {"model_type": "llama", "hidden_size": hidden,
           "intermediate_size": 512, "num_hidden_layers": layers,
           "num_attention_heads": heads, "num_key_value_heads": heads,
           "vocab_size": vocab, "max_position_embeddings": 512,
           "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
    save_hf_dir(str(path), cfg, sd, shards=2)
    return sd


# the port's Llama names -> HF's (no layout change: Linear is [out, in])
LAYER_NAMES = {"input_norm.scale": "input_layernorm.weight",
               "post_attn_norm.scale": "post_attention_layernorm.weight",
               "attn.wq.weight": "self_attn.q_proj.weight",
               "attn.wk.weight": "self_attn.k_proj.weight",
               "attn.wv.weight": "self_attn.v_proj.weight",
               "attn.wo.weight": "self_attn.o_proj.weight",
               "mlp.w_gate.weight": "mlp.gate_proj.weight",
               "mlp.w_up.weight": "mlp.up_proj.weight",
               "mlp.w_down.weight": "mlp.down_proj.weight"}


def _hf_name(name):
    top = {"embed_tokens.weight": "model.embed_tokens.weight",
           "norm.scale": "model.norm.weight",
           "lm_head.weight": "lm_head.weight"}
    if name in top:
        return top[name]
    _, i, rest = name.split(".", 2)
    return f"model.layers.{i}.{LAYER_NAMES[rest]}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_safetensors_directory_onto_the_card(cuda, tmp_path, dtype):
    sd = _llama_dir(tmp_path)
    eng = deepspeed_tpu_torch.init_inference(
        str(tmp_path), dtype=dtype, kv_cache_dtype=dtype)
    for name, t in eng.module.state_dict().items():
        assert t.device.type == "cuda"
        assert torch.equal(t.cpu(), sd[_hf_name(name)].to(t.dtype)), name
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (9, 30, 17)]
    want = [[int(x) for x in eng.generate(p[None], max_new_tokens=12)[
        0, len(p):]] for p in prompts]
    tdec.reset_launch_counts()
    sched = ServingScheduler(eng, num_slots=2, num_pages=16, page_size=16,
                             max_pages_per_slot=4, prefill_chunk=16)
    reqs = [sched.submit(p, max_new_tokens=12) for p in prompts]
    out = sched.run()
    assert [out[r.rid] for r in reqs] == want
    assert tdec.launch_counts()["paged_decode_fwd"] > 0


CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
          "gradient_clipping": 1.0, "steps_per_print": 1000}


def _trainer(seed):
    cfg = tgpt2.gpt2_tiny(dtype="bfloat16", hidden_size=128, num_heads=2,
                          max_seq_len=256)          # head_dim 64
    return deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(cfg), config=copy.deepcopy(CONFIG), seed=seed)[0]


def test_bf16_resume_equals_the_uninterrupted_run(cuda, tmp_path):
    g = torch.Generator(device=cuda).manual_seed(2)
    batches = [{"input_ids": torch.randint(0, 256, (2, 256), generator=g,
                                           device=cuda)} for _ in range(8)]
    a = _trainer(1)
    for i in (0, 2):
        a.train_batch(batches=batches[i:i + 2])
    a.save_checkpoint(str(tmp_path / "sync"))
    tfl.reset_launch_counts()
    want = [a.train_batch(batches=batches[i:i + 2]) for i in (4, 6)]
    assert tfl.launch_counts()["flash_fwd"] > 0
    b = _trainer(7)
    b.load_checkpoint(str(tmp_path / "sync"))
    assert [b.train_batch(batches=batches[i:i + 2]) for i in (4, 6)] == want
    for x, y in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(x, y)
    for xs, ys in ((a.optimizer.mu, b.optimizer.mu),
                   (a.optimizer.nu, b.optimizer.nu)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    before = [p.clone() for p in a.module.parameters()]
    a.save_checkpoint(str(tmp_path / "async"), async_save=True)
    a.train_batch(batches=batches[:2])
    a.wait_checkpoint()
    c = _trainer(9)
    c.load_checkpoint(str(tmp_path / "async"))
    for x, y, z in zip(c.module.parameters(), before, a.module.parameters()):
        assert torch.equal(x, y) and not torch.equal(x, z)
