"""Training-slice parity of the PyTorch port against the JAX package at
``gpt2_tiny`` size (2 layers, hidden 64, 4 heads, vocab 256), fp32.

The JAX engine is built with ``deepspeed_tpu.initialize`` on ONE virtual
CPU device (``mesh=make_mesh(MeshConfig(data=1), devices=[first])``), so
both sides see the same global batch; its initial params are carried to
the port with ``gpt2_params_from_jax`` and both take the same numpy
batches.  ``attn_impl="flash"`` runs the Pallas kernels in interpret
mode on the JAX side and the plain flash versions through the port's
``autograd.Function``; ``"reference"`` the plain attention on both.

Tolerances (fp32; the same math summed in other orders): logits atol
1e-4; per-step losses atol 1e-5; the step-1 global grad norm rtol 1e-5;
params after the steps atol 1e-5, 1% of the lr of 1e-3 (Adam's
normalised update moves a parameter by up to ~lr per step, and a
coordinate whose gradient is near zero turns rounding differences of
the gradient into differences of its update).
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

SEQ = 32
CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-3, "weight_decay": 0.1,
                             "betas": [0.9, 0.95]}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 2e-4, "warmup_max_lr": 1e-3,
                             "warmup_num_steps": 3,
                             "warmup_type": "linear"}},
    "gradient_clipping": 0.5,
    "steps_per_print": 1000,
}


def _batches(seed, n, batch=2):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (batch, SEQ)).astype(
        np.int32)} for _ in range(n)]


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(
        x, torch.Tensor) else x)


def _engines(attn_impl, config=CONFIG, batch=None):
    """(JAX engine, port engine) on the same initial weights."""
    batch = batch or _batches(99, 1)[0]
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jgpt2.GPT2(jgpt2.gpt2_tiny(attn_impl=attn_impl)),
        config=copy.deepcopy(config),
        mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]),
        example_batch=batch)
    params = jax.tree.map(np.asarray, jax.device_get(jeng.get_params()))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny(attn_impl=attn_impl)),
        config=copy.deepcopy(config), device="cpu")
    teng.set_params(tgpt2.gpt2_params_from_jax(params))
    return jeng, teng


def _assert_params_close(jeng, teng, atol):
    want = tgpt2.gpt2_params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(jeng.get_params())))
    got = teng.get_params()
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jax_tiny():
    jmodel = jgpt2.GPT2(jgpt2.gpt2_tiny(attn_impl="flash"))
    boxed = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(boxed)["params"])
    return jmodel, params


def test_weight_carry_covers_every_leaf(jax_tiny):
    _, params = jax_tiny
    state = tgpt2.gpt2_params_from_jax(params)
    model = tgpt2.GPT2(tgpt2.gpt2_tiny())
    model.load_state_dict(state, strict=True)
    leaves = jax.tree.leaves(params)
    assert len(leaves) == len(state)
    assert sum(x.size for x in leaves) == \
        sum(p.numel() for p in model.parameters())
    np.testing.assert_array_equal(
        _np(model.h[1].attn.qkv.weight),
        params["h_1"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(_np(model.ln_f.weight),
                                  params["ln_f"]["scale"])


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
@torch.no_grad()
def test_model_logits_and_loss_match_jax(jax_tiny, attn_impl):
    jmodel, params = jax_tiny
    jmodel = jgpt2.GPT2(jgpt2.gpt2_tiny(attn_impl=attn_impl))
    ids = np.random.default_rng(0).integers(0, 256, (2, SEQ)).astype(
        np.int32)
    want = jmodel.apply({"params": params}, jnp.asarray(ids))
    model = tgpt2.GPT2(tgpt2.gpt2_tiny(attn_impl=attn_impl))
    model.load_state_dict(tgpt2.gpt2_params_from_jax(params))
    got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    batch = {"input_ids": ids}
    np.testing.assert_allclose(
        float(tgpt2.gpt2_loss_fn(got, {"input_ids": torch.from_numpy(ids)})),
        float(jgpt2.gpt2_loss_fn(want, batch)), atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
def test_three_train_batch_steps_match_the_jax_engine(attn_impl):
    """AdamW with weight decay, gradient clipping and a WarmupLR schedule
    over three gas-1 steps: per-step losses, the step-1 grad norm, the
    learning rates and the final params."""
    jeng, teng = _engines(attn_impl)
    for i, batch in enumerate(_batches(1, 3)):
        assert teng.get_lr() == jeng.get_lr()
        want = jeng.train_batch(batches=[batch])
        got = teng.train_batch(batches=[batch])
        np.testing.assert_allclose(got, want, atol=1e-5)
        if i == 0:
            np.testing.assert_allclose(
                teng.get_global_grad_norm(),
                float(jax.device_get(jeng.get_global_grad_norm())),
                rtol=1e-5)
    assert teng.global_steps == jeng.global_steps == 3
    _assert_params_close(jeng, teng, atol=1e-5)


def test_gas2_window_matches_the_jax_engine():
    config = dict(CONFIG, gradient_accumulation_steps=2)
    jeng, teng = _engines("reference", config)
    for window in (_batches(2, 2), _batches(3, 2)):
        np.testing.assert_allclose(teng.train_batch(batches=window),
                                   jeng.train_batch(batches=window),
                                   atol=1e-5)
    np.testing.assert_allclose(
        teng.get_global_grad_norm(),
        float(jax.device_get(jeng.get_global_grad_norm())), rtol=1e-5)
    assert teng.micro_steps == 4 and teng.global_steps == 2
    _assert_params_close(jeng, teng, atol=1e-5)


def test_forward_backward_step_equals_train_batch():
    """The per-micro API (step() a no-op mid-window) is train_batch."""
    config = dict(CONFIG, gradient_accumulation_steps=2)
    window = _batches(4, 2)
    a = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=config, device="cpu")[0]
    b = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=config, device="cpu")[0]
    a.train_batch(batches=window)
    for batch in window:
        b.backward(b.forward(batch))
        metrics = b.step()
    assert metrics is not None and b.global_steps == 1
    for name, p in a.get_params().items():
        torch.testing.assert_close(b.get_params()[name], p, rtol=0, atol=0)


def test_train_loop_equals_train_batch_calls():
    batches = _batches(5, 4)
    loop = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=CONFIG, seed=3,
        device="cpu")[0]
    calls = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=CONFIG, seed=3,
        device="cpu")[0]
    losses = loop.train_loop(batches, sync=True)
    want = [calls.train_batch(batches=[b]) for b in batches]
    np.testing.assert_array_equal(losses, np.float32(want))
    assert loop.global_steps == calls.global_steps == 4
    for name, p in calls.get_params().items():
        torch.testing.assert_close(loop.get_params()[name], p, rtol=0,
                                   atol=0)
    assert float(loop.eval_batch(batches[0])) < losses[0]


def test_seeded_init_is_reproducible_and_follows_flax_initializers():
    e1 = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=CONFIG, seed=7,
        device="cpu")[0]
    e2 = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=CONFIG, seed=7,
        device="cpu")[0]
    p1, p2 = e1.get_params(), e2.get_params()
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name
    assert torch.equal(p1["h.0.ln_1.weight"], torch.ones(64))
    assert not p1["h.0.attn.qkv.bias"].any()
    assert abs(float(p1["wte"].std()) - 0.02) < 2e-3
    assert abs(float(p1["wpe"].std()) - 0.01) < 1e-3


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_num_steps": 10}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 5}),
    ("LRRangeTest", {"lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 4, "decay_step_size": 2,
                  "decay_lr_rate": 0.5})])
def test_lr_schedules_match_jax(name, params):
    want = jlr.LRScheduler(jlr.get_lr_schedule(name, params))
    got = tlr.LRScheduler(tlr.get_lr_schedule(name, params))
    for _ in range(25):
        assert got.get_lr() == want.get_lr()
        got.step()
        want.step()


@pytest.mark.parametrize("opt", [
    {"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                "adam_w_mode": False}},
    {"type": "FusedAdam", "params": {"lr": 2e-3, "eps": 1e-6}}])
def test_adam_spellings_match_the_jax_engine(opt):
    config = dict(CONFIG, optimizer=opt)
    jeng, teng = _engines("reference", config)
    for batch in _batches(6, 2):
        np.testing.assert_allclose(teng.train_batch(batches=[batch]),
                                   jeng.train_batch(batches=[batch]),
                                   atol=1e-5)
    _assert_params_close(jeng, teng, atol=1e-5)


@pytest.mark.parametrize("key,value,item", [
    ("zero_optimization", {"stage": 3}, "A12"),
    ("activation_checkpointing", {"partition_activations": True}, "A13"),
    ("progressive_layer_drop", {"enabled": True}, "A16"),
    ("data_efficiency", {"enabled": True}, "A16"),
    ("compression_training", {"weight_quantization": {}}, "A17"),
    ("eigenvalue", {"enabled": True}, "A17"),
    ("checkpoint", {"load_universal": True}, "A10"),
    ("zero_optimization", {"stage": 2}, "A12"),
    ("zero_optimization", {"stage": 1,
                           "offload_optimizer": {"device": "cpu"}}, "A12"),
    ("mesh", {"data": 4}, "A12"),
    ("optimizer", {"type": "Lamb"}, "A18")])
def test_unported_config_sections_name_their_roadmap_item(key, value, item):
    config = dict(CONFIG, **{key: value})
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=config, device="cpu")


def test_config_resolves_batches_and_rejects_unknown_keys(tmp_path):
    cfg = DeepSpeedConfig.load({"train_batch_size": 8,
                                "gradient_accumulation_steps": 4,
                                "zero_optimization": {"stage": 1},
                                "fp16": {"enabled": False},
                                "bfloat16": {"enabled": True}})
    assert (cfg.train_micro_batch_size_per_gpu, cfg.zero_optimization_stage,
            cfg.precision_dtype) == (2, 1, "bfloat16")
    with pytest.raises(ValueError, match="unknown"):
        DeepSpeedConfig.load({"train_batch_size": 8, "no_such_key": 1})
    with pytest.raises(ValueError, match="batch"):
        DeepSpeedConfig.load({"train_batch_size": 8,
                              "train_micro_batch_size_per_gpu": 3,
                              "gradient_accumulation_steps": 2})
    path = tmp_path / "ds.json"
    path.write_text('{"train_batch_size": 2, "train_batch_size": 4}')
    with pytest.raises(ValueError, match="duplicate"):
        DeepSpeedConfig.load(str(path))


@pytest.mark.parametrize("field,value,item", [
    ("dropout", 0.1, "A14"), ("remat", True, "A13"),
    ("scan_layers", True, "A13"), ("moe_num_experts", 4, "A10"),
    ("attn_impl", "ring", "A10")])
def test_unported_model_features_name_their_roadmap_item(field, value,
                                                         item):
    with pytest.raises(NotImplementedError, match=item):
        tgpt2.gpt2_tiny(**{field: value})


def test_unported_model_branches_and_engine_calls_raise():
    model = tgpt2.GPT2(tgpt2.gpt2_tiny())
    ids = torch.zeros(1, 4, dtype=torch.long)
    for kw, item in ((dict(pld_theta=0.5), "A16"),
                     (dict(rltd_keep=2), "A16")):
        with pytest.raises(NotImplementedError, match=item):
            model(ids, **kw)
    with pytest.raises(ValueError, match="cfg.dtype"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.GPT2(tgpt2.gpt2_tiny()),
            config=dict(CONFIG, bf16={"enabled": True}), device="cpu")


def test_local_windows_over_pools_are_refused():
    """The refusal that stays: GPT-Neo's local windows serve through the
    dense cache only, as in the JAX model
    (``deepspeed_tpu/models/gpt2.py:155-156``); over pools the module
    and the engine raise naming the JAX limit."""
    cfg = tgpt2.gpt2_tiny(attn_windows=(0, 16))
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(cfg), dtype="float32", kv_cache_dtype="float32",
        device="cpu").init_params(0)
    with pytest.raises(NotImplementedError, match="local attn_windows"):
        eng.init_paged_cache(4, 8)
    pools = tgpt2.init_paged_kv_cache(cfg, 4, 8, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="local attn_windows"):
        eng.module(torch.zeros(1, 1, dtype=torch.long), cache=dict(
            pools, page_table=torch.zeros(1, 2, dtype=torch.int32),
            lengths=torch.zeros(1, dtype=torch.int32),
            active=torch.ones(1, dtype=torch.bool)))
    out = eng.generate(np.arange(20)[None], max_new_tokens=4)
    assert out.shape == (1, 24)
