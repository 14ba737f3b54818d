"""Training checkpoints in the port (``deepspeed_tpu_torch.checkpoint``),
in the JAX package's on-disk layout, at ``gpt2_tiny`` size on the CPU.

Oracles: a resumed port run equals the uninterrupted one bit for bit
(losses, masters, AdamW moments; gas 2, ZeRO 0 and 1, sync and async
saves); a JAX training engine's checkpoint — one device, and a ZeRO-1 one
over the 8-device mesh, whose optimizer moments are sliced 8 ways and
assemble to the JAX engine's — serves through the port's ``checkpoint=`` with the JAX engine's logits
(atol 1e-4) and with int8 weights equal to the JAX ``QTensor`` leaves bit
for bit; a port checkpoint serves through the JAX ``InferenceEngine(
checkpoint=)`` with the port's logits.  Also: format-1 read-back, CRC
corruption, a re-saved tag's stale shards, a shape mismatch,
``consolidate`` / ``zero_to_fp32`` / ``save_16bit_model``, the async
snapshot taken before the save returns, and a custom
``checkpoint_engine`` type.
"""

import copy
import json
import os
import threading
import zipfile

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.checkpoint import engine as ckpt
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.checkpoint.backend import NpzCheckpointEngine
from deepspeed_tpu_torch.checkpoint.params import jax_leaf_names
from deepspeed_tpu_torch.models import gpt2 as tgpt2

CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
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
QUANT = {"enabled": True, "group_size": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seed, n, batch=2):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (batch, 32)).astype(
        np.int32)} for _ in range(n)]


def port_trainer(config=CONFIG, seed=3):
    return deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2(tgpt2.gpt2_tiny()), config=copy.deepcopy(config),
        device="cpu", seed=seed)[0]


def _windows(engine, batches, first, n):
    gas = engine.gas
    return [engine.train_batch(batches=batches[i:i + gas])
            for i in range(first * gas, (first + n) * gas, gas)]


def _same_state(a, b):
    for (n, x), y in zip(a.module.named_parameters(),
                         b.module.parameters()):
        assert torch.equal(x, y), n
    for xs, ys in ((a.optimizer.mu, b.optimizer.mu),
                   (a.optimizer.nu, b.optimizer.nu)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    assert a.optimizer.count == b.optimizer.count
    assert (a.global_steps, a.micro_steps, a.global_samples) == \
        (b.global_steps, b.micro_steps, b.global_samples)
    assert a.get_lr() == b.get_lr()


@pytest.mark.parametrize("stage,async_save", [(0, False), (1, False),
                                              (1, True)])
def test_resume_equals_the_uninterrupted_run(tmp_path, stage, async_save):
    """Two gas-2 windows, a save, two more; a fresh engine loading the save
    takes the same two windows to the same losses, masters, moments,
    counters and learning rate, bit for bit."""
    config = dict(CONFIG, zero_optimization={"stage": stage})
    batches = _batches(1, 8)
    a = port_trainer(config)
    _windows(a, batches, 0, 2)
    a.save_checkpoint(str(tmp_path), client_state={"epoch": 7},
                      async_save=async_save)
    want = _windows(a, batches, 2, 2)
    a.wait_checkpoint()
    b = port_trainer(config, seed=11)
    path, client = b.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and client["epoch"] == 7
    assert _windows(b, batches, 2, 2) == want
    _same_state(a, b)


def test_async_snapshot_is_taken_before_save_returns(tmp_path,
                                                     monkeypatch):
    """The write is held until a step has run after ``save_checkpoint``
    returned: the files still hold the pre-step masters."""
    gate = threading.Event()
    write = ckpt._write_npz_streaming

    def held(path, chunks):
        gate.wait(30)
        return write(path, chunks)
    monkeypatch.setattr(ckpt, "_write_npz_streaming", held)
    a = port_trainer()
    batches = _batches(2, 4)
    _windows(a, batches, 0, 1)
    before = {n: p.clone() for n, p in a.module.named_parameters()}
    a.save_checkpoint(str(tmp_path), async_save=True)
    _windows(a, batches, 1, 1)
    gate.set()
    a.wait_checkpoint()
    b = port_trainer(seed=5)
    b.load_checkpoint(str(tmp_path))
    for n, p in b.module.named_parameters():
        assert torch.equal(p, before[n]), n
        assert not torch.equal(p, dict(a.module.named_parameters())[n])


def test_layout_names_and_verify(tmp_path):
    """The JAX layout: meta format 2 with leaves (JAX names, ``[in, out]``
    kernels), client state, save id and entry CRCs; one ``ZIP_STORED``
    shard file of that id; ``latest``; ``.step`` stored as ``(1,)``."""
    a = port_trainer()
    _windows(a, _batches(3, 2), 0, 1)
    a.save_checkpoint(str(tmp_path), tag="t")
    assert open(tmp_path / "latest").read() == "t"
    tag = tmp_path / "t"
    meta = json.loads((tag / "checkpoint_meta.json").read_text())
    assert meta["format"] == 2 and meta["client_state"]["global_steps"] == 1
    leaves = meta["leaves"]
    assert leaves[".params['h_0']['attn']['qkv']['kernel']"] == {
        "shape": [64, 192], "dtype": "float32"}
    assert leaves[".params['ln_f']['scale']"]["shape"] == [64]
    assert leaves[".step"] == {"shape": [], "dtype": "int32"}
    shard = f"shards_p00000.{meta['save_id']}.npz"
    assert sorted(os.listdir(tag)) == ["checkpoint_meta.json", shard]
    with zipfile.ZipFile(tag / shard) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
        assert set(meta["entry_crc32"]) == {
            n[:-len(".npy")] for n in z.namelist()}
    with np.load(tag / shard) as d:
        assert d[".step|"].shape == (1,)
        np.testing.assert_array_equal(
            d[".params['h_0']['attn']['qkv']['kernel']|0:64,0:192"],
            a.module.h[0].attn.qkv.weight.detach().numpy().T)
    assert ckpt.verify_checkpoint(str(tag)) == (True, [])


def test_corruption_stale_shards_and_shape_mismatch(tmp_path):
    """A flipped byte fails ``verify_checkpoint`` and raises
    ``CheckpointCorrupt`` at load; re-saving a tag drops its old shard
    file, and a stale file of another save id is ignored; a model of
    another width raises ValueError."""
    a = port_trainer()
    batches = _batches(4, 4)
    _windows(a, batches, 0, 1)
    a.save_checkpoint(str(tmp_path), tag="t")
    tag = tmp_path / "t"
    old = [f for f in os.listdir(tag) if f.startswith("shards")][0]
    stale = (tag / old).read_bytes()
    _windows(a, batches, 1, 1)
    a.save_checkpoint(str(tmp_path), tag="t")
    new = [f for f in os.listdir(tag) if f.startswith("shards")]
    assert len(new) == 1 and new[0] != old
    (tag / old).write_bytes(stale)          # a stale file left beside it
    b = port_trainer(seed=9)
    b.load_checkpoint(str(tmp_path))
    _same_state(a, b)
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny(hidden_size=32)), dtype="float32",
        device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.load_checkpoint(str(tmp_path))
    raw = bytearray((tag / new[0]).read_bytes())
    key = ".params['wte']|0:256,0:64.npy"
    at = raw.find(key.encode()) + len(key) + 200
    raw[at] ^= 0xFF
    (tag / new[0]).write_bytes(bytes(raw))
    ok, problems = ckpt.verify_checkpoint(str(tag))
    assert not ok and any("crc" in p.lower() for p in problems)
    with pytest.raises(ckpt.CheckpointCorrupt):
        port_trainer().load_checkpoint(str(tmp_path))


def test_format1_consolidate_zero_to_fp32_and_16bit(tmp_path):
    """A round-1 ``model_states.npz`` serves; ``consolidate`` and the
    ``zero_to_fp32`` CLI write the masters under their JAX names; the
    16-bit file of ``save_16bit_model`` equals ``consolidate`` at
    float16, and ``gather_16bit_weights_on_model_save`` leaves it beside
    the save."""
    config = dict(CONFIG, zero_optimization={
        "stage": 1, "stage3_gather_16bit_weights_on_model_save": True})
    a = port_trainer(config)
    _windows(a, _batches(5, 2), 0, 1)
    a.save_checkpoint(str(tmp_path / "run"))
    tag = tmp_path / "run" / "global_step1"
    out = tmp_path / "fp32.npz"
    assert zero_to_fp32.main([str(tmp_path / "run"), str(out)]) == 0
    names = jax_leaf_names(a.module)
    params = dict(a.module.named_parameters())
    with np.load(out) as d:
        assert len(d.files) == len(names)
        for name, (leaf, tr) in names.items():
            w = params[name].detach().numpy()
            np.testing.assert_array_equal(d[".params" + leaf],
                                          w.T if tr else w)
    a.save_16bit_model(str(tmp_path), "w16.npz")
    with np.load(tmp_path / "w16.npz") as x, \
            np.load(tag / "weights_16bit.npz") as y:
        assert x.files == y.files
        for k in x.files:
            assert x[k].dtype == np.float16
            np.testing.assert_array_equal(x[k], y[k])
    # format 1: one model_states.npz of .params entries
    f1 = tmp_path / "f1"
    f1.mkdir()
    with np.load(out) as d:
        np.savez(f1 / "model_states.npz", **{k: d[k] for k in d.files})
    assert ckpt.verify_checkpoint(str(f1)) == (True, [])
    eng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny()), dtype="float32", device="cpu",
        checkpoint={"checkpoint_dir": str(f1)})
    for n, p in eng.module.named_parameters():
        assert torch.equal(p, params[n]), n


class RecordingEngine(NpzCheckpointEngine):
    """A custom backend: the native format, with its calls recorded."""

    calls = []

    def create(self, tag):
        self.calls.append(("create", tag, self.params.get("who")))

    def commit(self, tag):
        self.calls.append(("commit", tag))

    def load_subtree(self, path, target, prefix):
        self.calls.append(("load_subtree", prefix))
        return super().load_subtree(path, target, prefix)


def test_custom_checkpoint_engine_type(tmp_path):
    section = {"type": f"{__name__}:RecordingEngine",
               "params": {"who": "me"}}
    RecordingEngine.calls.clear()
    a = port_trainer(dict(CONFIG, checkpoint_engine=section))
    assert isinstance(a.checkpoint_engine, RecordingEngine)
    a.save_checkpoint(str(tmp_path), tag="x")
    deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny()), dtype="float32", device="cpu",
        checkpoint=str(tmp_path), checkpoint_engine=section)
    assert RecordingEngine.calls == [("create", "x", "me"), ("commit", "x"),
                                     ("load_subtree", ".params")]
    with pytest.raises(ValueError, match="package.module:ClassName"):
        port_trainer(dict(CONFIG, checkpoint_engine={"type": "nope"}))


# ---------------------------------------------- across the two packages


def jax_trainer(mesh_cfg, zero_stage):
    batch = _batches(9, 1, batch=2 * mesh_cfg.data)[0]
    config = dict(CONFIG, gradient_accumulation_steps=1,
                  train_micro_batch_size_per_gpu=2,
                  zero_optimization={"stage": zero_stage})
    devices = jax.devices()[:mesh_cfg.data * mesh_cfg.model]
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=jgpt2.GPT2(jgpt2.gpt2_tiny()), config=config,
        mesh=make_mesh(mesh_cfg, devices=devices), example_batch=batch)
    eng.train_batch(batches=[batch])
    return eng


@pytest.fixture(scope="module", params=["one_device", "zero1_mesh_8"])
def jax_checkpoint(request, tmp_path_factory):
    """A JAX training engine's checkpoint after one step, and its params."""
    path = tmp_path_factory.mktemp(request.param)
    if request.param == "one_device":
        eng = jax_trainer(MeshConfig(data=1), 0)
    else:
        eng = jax_trainer(MeshConfig(data=8), 1)
    eng.save_checkpoint(str(path))
    params = jax.tree.map(np.asarray, jax.device_get(eng.get_params()))
    flat = jax.tree_util.tree_flatten_with_path(eng._live_state())[0]
    mu = {jax.tree_util.keystr(k): np.asarray(jax.device_get(v))
          for k, v in flat if ".mu[" in jax.tree_util.keystr(k)}
    return request.param, str(path), params, mu


def test_jax_checkpoint_serves_in_the_port(jax_checkpoint):
    """The JAX masters come back as they are, the sliced moments of the
    mesh run assemble to the JAX engine's, logits equal the JAX inference engine's over the
    same checkpoint, and int8 weights equal its ``QTensor`` leaves."""
    name, path, params, mu = jax_checkpoint
    if name == "zero1_mesh_8":
        with zipfile.ZipFile(os.path.join(path, "global_step1", [
                f for f in os.listdir(os.path.join(path, "global_step1"))
                if f.startswith("shards")][0])) as z:
            assert sum(".mu['h_0']['attn']['qkv']['kernel']|" in n
                       for n in z.namelist()) == 8      # sliced 8 ways
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny()), dtype="float32", device="cpu",
        checkpoint=path)
    want = tgpt2.gpt2_params_from_jax(params)
    for n, p in teng.module.state_dict().items():
        assert torch.equal(p, want[n]), n
    jeng = deepspeed_tpu.init_inference(
        model=jgpt2.GPT2(jgpt2.gpt2_tiny()), dtype="float32",
        mesh={"data": 1, "model": 1}, checkpoint=path)
    ids = _batches(6, 1)[0]["input_ids"]
    np.testing.assert_allclose(teng.forward(ids).numpy(),
                               np.asarray(jeng.forward(ids)), atol=1e-4,
                               rtol=1e-4)
    tq = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny()), dtype="float32", quant=QUANT,
        device="cpu", checkpoint={"checkpoint_dir": path})
    jq = deepspeed_tpu.init_inference(
        model=jgpt2.GPT2(jgpt2.gpt2_tiny()), dtype="float32", quant=QUANT,
        mesh={"data": 1, "model": 1}, checkpoint=path)
    jtree = jq.params
    for i in range(2):
        for group, names in (("attn", ("qkv", "proj")),
                             ("mlp", ("fc_in", "fc_out"))):
            for n in names:
                jk = jtree[f"h_{i}"][group][n]["kernel"]
                layer = getattr(getattr(tq.module.h[i], group), n)
                np.testing.assert_array_equal(layer.q.numpy(),
                                              np.asarray(jk.q))
                np.testing.assert_array_equal(layer.scale.numpy(),
                                              np.asarray(jk.scale))
    if name == "one_device":
        # the port's trainer takes the JAX masters (not its optimizer)
        t = port_trainer()
        with pytest.raises(KeyError, match="load_optimizer_states=False"):
            t.load_checkpoint(path)
        t.load_checkpoint(path, load_optimizer_states=False)
        for n, p in t.module.named_parameters():
            assert torch.equal(p, want[n]), n
    # every JAX optimizer moment, sliced over the mesh's devices or not,
    # assembles to the JAX engine's own
    got = ckpt.load_subtree(os.path.join(path, "global_step1"),
                            {k: v.shape for k, v in mu.items()})
    for k, v in mu.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_port_checkpoint_serves_in_the_jax_engine(tmp_path):
    a = port_trainer(dict(CONFIG, zero_optimization={"stage": 1}))
    _windows(a, _batches(7, 4), 0, 2)
    a.save_checkpoint(str(tmp_path))
    jeng = deepspeed_tpu.init_inference(
        model=jgpt2.GPT2(jgpt2.gpt2_tiny()), dtype="float32",
        mesh={"data": 1, "model": 1}, checkpoint=str(tmp_path))
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2(tgpt2.gpt2_tiny()), dtype="float32", device="cpu",
        checkpoint=str(tmp_path))
    ids = _batches(8, 1)[0]["input_ids"]
    np.testing.assert_allclose(np.asarray(jeng.forward(ids)),
                               teng.forward(ids).numpy(), atol=1e-4,
                               rtol=1e-4)
    with torch.no_grad():
        np.testing.assert_array_equal(
            teng.forward(ids).numpy(),
            a.module(torch.as_tensor(ids).long()).numpy())
