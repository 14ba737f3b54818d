"""fp16 training in the port against the JAX package, on the CPU.

* ``update_scale`` (``runtime/fp16/loss_scaler.py``) against the JAX
  function bit for bit over hypothesis-drawn overflow sequences: dynamic
  with both hysteresis modes, a ``min_scale`` floor, a short window, and
  a static scale.
* ``gpt2_tiny`` at float16 (``"fp16": {"enabled": true}``), the JAX
  engine on one virtual CPU device and the port on the same initial
  weights: per-step losses within 1e-3 (float16 activations; the
  losses are ~5.6, where one float16 rounding is 3.9e-3 and the
  float32-accumulated means differ by ~2e-5), the loss scale, the
  skipped steps and the overflow flags exactly equal, at
  ``initial_scale_power`` 16 (no overflow; the masters after 4 steps
  within 4e-3, 4 x the learning rate, since a float16 rounding can turn
  around a near-zero gradient's Adam update) and 32 (every step
  overflows: the scale follows hysteresis 2, then halving).
* A forced overflow: a ``loss_fn`` that multiplies the loss by the
  batch's ``factor``, ``inf`` on one chosen step, in both packages: on
  that step the masters, the AdamW moments and the optimizer count stay
  bit for bit, ``skipped_steps`` counts it, the step counter and the
  schedule advance.
* Checkpoints across the packages: a port fp16 checkpoint read by the
  JAX checkpoint reader gives its masters, scaler and skipped steps to a
  JAX fp16 engine; a JAX fp16 checkpoint loads into the port with its
  scaler (``load_optimizer_states=False``: the JAX optax moments are not
  mapped, ROADMAP.md A8c).
"""

import copy

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import engine as jckpt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

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
    "fp16": {"enabled": True, "initial_scale_power": 16},
}
LOSS_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the loss scaler


def _scalers(scale, hysteresis, window, min_scale, consecutive, dynamic):
    static = dict(scale_window=window, min_scale=min_scale,
                  init_hysteresis=hysteresis, dynamic=dynamic,
                  consecutive_hysteresis=consecutive)
    j = jls.LossScaleState(loss_scale=jnp.float32(scale),
                           good_steps=jnp.int32(0),
                           hysteresis=jnp.int32(hysteresis), **static)
    t = tls.LossScaleState(
        loss_scale=torch.tensor(scale, dtype=torch.float32),
        good_steps=torch.zeros((), dtype=torch.int32),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32), **static)
    return j, t


@settings(max_examples=60, deadline=None)
@given(overflows=st.lists(st.booleans(), min_size=1, max_size=40),
       power=st.integers(0, 32), hysteresis=st.integers(1, 4),
       window=st.integers(1, 6), min_scale=st.sampled_from([1.0, 0.25, 8.0]),
       consecutive=st.booleans(), dynamic=st.booleans())
def test_update_scale_matches_jax_bit_for_bit(overflows, power, hysteresis,
                                              window, min_scale, consecutive,
                                              dynamic):
    j, t = _scalers(2.0 ** power, hysteresis, window, min_scale, consecutive,
                    dynamic)
    for ovf in overflows:
        j = jls.update_scale(j, jnp.bool_(ovf))
        t = tls.update_scale(t, torch.tensor(ovf))
        assert np.asarray(j.loss_scale).tobytes() == \
            t.loss_scale.numpy().tobytes()
        assert int(j.good_steps) == int(t.good_steps)
        assert int(j.hysteresis) == int(t.hysteresis)
        assert t.good_steps.dtype == t.hysteresis.dtype == torch.int32


def test_has_overflow_and_the_host_scaler():
    assert not bool(tls.has_overflow([torch.ones(3), torch.zeros(2)]))
    for bad in (float("inf"), float("-inf"), float("nan")):
        assert bool(tls.has_overflow([torch.ones(3), torch.tensor([bad])]))
    s = tls.DynamicLossScaler(init_scale=8.0, delayed_shift=1)
    s.update_scale(True)
    assert s.loss_scale == 4.0
    assert float(s.backward(torch.tensor(2.0))) == 8.0
    static = tls.LossScaler(scale=128.0)
    static.update_scale(True)
    assert static.loss_scale == 128.0


def test_config_accepts_fp16_and_data_types():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = DeepSpeedConfig.load({
        "train_batch_size": 4,
        "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 12,
                 "loss_scale_window": 100, "hysteresis": 3,
                 "min_loss_scale": 2, "auto_cast": False,
                 "consecutive_hysteresis": True},
        "data_types": {"grad_accum_dtype": "fp32"}})
    assert cfg.precision_dtype == "float16"
    assert cfg.fp16.dynamic_loss_scale and \
        cfg.fp16.initial_dynamic_scale == 4096
    state = tls.make_loss_scale_state(cfg.fp16)
    assert (float(state.loss_scale), int(state.hysteresis),
            state.scale_window, state.min_scale,
            state.consecutive_hysteresis) == (4096.0, 3, 100, 2.0, True)
    static = DeepSpeedConfig.load({"train_batch_size": 4,
                                   "fp16": {"enabled": True,
                                            "loss_scale": 64}})
    assert static.fp16.initial_dynamic_scale == 64 and \
        not tls.make_loss_scale_state(static.fp16).dynamic
    with pytest.raises(ValueError, match="cannot both be enabled"):
        DeepSpeedConfig.load({"train_batch_size": 4,
                              "fp16": {"enabled": True},
                              "bf16": {"enabled": True}})
    with pytest.raises(ValueError):
        DeepSpeedConfig.load({"train_batch_size": 4,
                              "fp16": {"enabled": True, "no_such": 1}})
    with pytest.raises(ValueError, match="float16"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.GPT2(tgpt2.gpt2_tiny()), device="cpu",
            config={"train_batch_size": 2, "fp16": {"enabled": True}})


# ------------------------------------------------------------ training


def _batches(seed, n, factors=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = {"input_ids": rng.integers(0, 256, (2, SEQ)).astype(np.int32)}
        if factors is not None:
            b["factor"] = np.full((2,), factors[i], np.float32)
        out.append(b)
    return out


def _jax_factor_loss(module):
    def loss_fn(params, batch, rng):
        logits = module.apply({"params": params}, batch["input_ids"])
        return jgpt2.gpt2_loss_fn(logits, batch) * batch["factor"][0]
    return loss_fn


def _port_factor_loss(module, batch):
    return tgpt2.gpt2_loss_fn(module(batch["input_ids"]), batch) * \
        batch["factor"][0]


def _engines(config=CONFIG, factor_loss=False, batch=None):
    """(JAX engine, port engine) on the same initial weights, fp16."""
    batch = batch or _batches(99, 1, [1.0] if factor_loss else None)[0]
    jmodel = jgpt2.GPT2(jgpt2.gpt2_tiny(attn_impl="reference",
                                        dtype=jnp.float16))
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=copy.deepcopy(config),
        loss_fn=_jax_factor_loss(jmodel) if factor_loss else None,
        mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]),
        example_batch=batch)
    params = jax.tree.map(np.asarray, jax.device_get(jeng.get_params()))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny(attn_impl="reference",
                                         dtype="float16")),
        config=copy.deepcopy(config), device="cpu",
        loss_fn=_port_factor_loss if factor_loss else None)
    teng.set_params(tgpt2.gpt2_params_from_jax(params))
    return jeng, teng


def _state(teng):
    """Copies of the port's masters, moments and count."""
    opt = teng.optimizer
    return ([p.detach().clone() for p in teng.module.parameters()],
            [m.clone() for m in opt.mu], [v.clone() for v in opt.nu],
            opt.count.clone())


def _same(a, b):
    return all(torch.equal(x, y) for xs, ys in zip(a[:3], b[:3])
               for x, y in zip(xs, ys)) and torch.equal(a[3], b[3])


def _jax_params(jeng):
    return tgpt2.gpt2_params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(jeng.get_params())))


@pytest.mark.parametrize("power", [16, 32])
def test_fp16_steps_match_the_jax_engine(power):
    config = dict(CONFIG, fp16=dict(CONFIG["fp16"],
                                    initial_scale_power=power))
    jeng, teng = _engines(config)
    for batch in _batches(6, 4):
        before = _state(teng)
        jl = jeng.train_batch(batches=[batch])
        tl = teng.train_batch(batches=[batch])
        np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL)
        ovf = bool(teng._last_metrics["overflow"])
        assert ovf == bool(jeng._last_metrics["overflow"])
        assert teng.loss_scale == jeng.loss_scale
        assert float(teng._last_metrics["loss_scale"]) == jeng.loss_scale
        assert teng.skipped_steps == jeng.skipped_steps
        assert _same(before, _state(teng)) == ovf
    assert teng.global_steps == jeng.global_steps == 4
    if power == 32:
        # every step overflows: hysteresis 2, then halving
        assert teng.skipped_steps == 4 and teng.loss_scale == 2.0 ** 30
        assert int(teng.optimizer.count) == 0
    else:
        assert teng.skipped_steps == 0 and teng.loss_scale == 2.0 ** 16
        assert int(teng.optimizer.count) == 4
        want = _jax_params(jeng)
        for name, p in teng.get_params().items():
            # Adam moves a parameter by up to ~lr (1e-3) a step, and a
            # float16 rounding of a near-zero gradient can turn its
            # update around: 4 steps x lr
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       atol=4e-3, err_msg=name)


def test_forced_overflow_skips_the_step_in_both_packages():
    factors = [1.0, 1.0, float("inf"), 1.0]
    jeng, teng = _engines(factor_loss=True)
    for i, batch in enumerate(_batches(7, 4, factors)):
        before, jbefore = _state(teng), _jax_params(jeng)
        jeng.train_batch(batches=[batch])
        teng.train_batch(batches=[batch])
        ovf = bool(teng._last_metrics["overflow"])
        assert ovf == bool(jeng._last_metrics["overflow"]) == (i == 2)
        assert (teng.loss_scale, teng.skipped_steps) == \
            (jeng.loss_scale, jeng.skipped_steps)
        # the step counter and the schedule advance either way
        assert teng.global_steps == jeng.global_steps == i + 1
        assert teng.lr_scheduler.last_step == i + 1
        if ovf:
            assert _same(before, _state(teng))
            after = _jax_params(jeng)
            assert all(torch.equal(jbefore[k], after[k]) for k in after)
        else:
            assert not _same(before, _state(teng))
    assert teng.skipped_steps == 1 and int(teng.optimizer.count) == 3
    assert teng.global_steps == 4


def test_fp16_checkpoints_cross_the_packages(tmp_path):
    """Port -> JAX: the JAX checkpoint reader gives a JAX fp16 engine the
    port's masters, scaler and skipped steps, and the next step's scale
    update agrees.  JAX -> port: the scaler and skipped steps load with
    the masters; a bf16 port engine keeps its unit scaler."""
    factors = [1.0, float("inf"), 1.0]
    jeng, teng = _engines(factor_loss=True)
    for batch in _batches(8, 3, factors):
        teng.train_batch(batches=[batch])
    assert teng.skipped_steps == 1
    path = teng.save_checkpoint(str(tmp_path / "port"))
    live = jeng._live_state()
    jeng.state = live.replace(
        params=jckpt.load_subtree(path, live.params, ".params"),
        scaler=jckpt.load_subtree(path, live.scaler, ".scaler"),
        skipped_steps=jckpt.load_subtree(path, live.skipped_steps,
                                         ".skipped_steps"))
    assert (jeng.loss_scale, jeng.skipped_steps) == \
        (teng.loss_scale, teng.skipped_steps)
    want = _jax_params(jeng)
    for name, p in teng.get_params().items():
        assert torch.equal(p, want[name]), name
    # a fresh port engine resumes the same scaler
    _, resumed = _engines(factor_loss=True)
    resumed.load_checkpoint(str(tmp_path / "port"))
    assert (resumed.loss_scale, resumed.skipped_steps,
            int(resumed.optimizer.count)) == \
        (teng.loss_scale, teng.skipped_steps, int(teng.optimizer.count))

    # JAX -> port
    jeng2, teng2 = _engines(factor_loss=True)
    for batch in _batches(9, 3, [float("inf"), 1.0, float("inf")]):
        jeng2.train_batch(batches=[batch])
    jeng2.save_checkpoint(str(tmp_path / "jax"))
    teng2.load_checkpoint(str(tmp_path / "jax"), load_optimizer_states=False)
    assert (teng2.loss_scale, teng2.skipped_steps) == \
        (jeng2.loss_scale, jeng2.skipped_steps) == (32768.0, 2)
    assert int(teng2.scaler.hysteresis) == \
        int(jeng2._live_state().scaler.hysteresis)
    want = _jax_params(jeng2)
    for name, p in teng2.get_params().items():
        assert torch.equal(p, want[name]), name
    bf16 = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny(dtype="bfloat16")), device="cpu",
        config=dict(CONFIG, fp16={"enabled": False},
                    bf16={"enabled": True}))[0]
    bf16.load_checkpoint(str(tmp_path / "jax"), load_optimizer_states=False)
    assert (bf16.loss_scale, bf16.skipped_steps) == (1.0, 0)
