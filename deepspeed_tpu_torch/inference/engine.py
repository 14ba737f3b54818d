"""InferenceEngine: the serving wrapper of the PyTorch port (counterpart
of ``deepspeed_tpu/inference/engine.py``).

What carries over: ``init_params`` / ``set_params`` (with weight-only
int8 quantization of every ``QDense`` when the config's ``quant`` section
is enabled), ``generate`` over a dense KV cache bucketed to 128
positions, greedy or sampled (``do_sample`` / ``temperature`` /
``top_k`` / ``top_p`` from the engine's key), ``sample_from_logits`` and
``sample_from_logits_policy``, and the slot primitives the paged
scheduler drives — ``init_paged_cache`` (float or int8 / fp8 pools, per
pool), ``prefill_into_slots``, ``decode_step``, ``decode_multi`` and
``verify_multi`` (speculative verification), their decoding-policy twins
``decode_multi_policy`` and ``verify_multi_policy``, and ``copy_page``
(the prefix cache's copy-on-write).  ``load_checkpoint`` (and the
config's ``checkpoint``) serves a training checkpoint of either package;
a module ingested from HF arrives on the ``meta`` device and is filled
leaf by leaf.

``decode_multi`` is the JAX ``lax.scan`` over the horizon written as a
Python loop whose carries (token, active mask, lengths, emitted count)
stay on the device; ``verify_multi`` is one teacher-forced forward over
K+1 columns per slot with the greedy acceptance on the device.  The JAX
package jits each once per horizon / spec-K bucket; here a CUDA engine
captures each body once per bucket as a CUDA graph (over static input
buffers and the pools it was captured with) and replays it, unless the
config's ``enable_cuda_graph`` is False.  A graph lives as long as its
pools and the module's weights it was captured over: it goes when a
pool leaf is freed, and every graph goes when a weight is replaced (by
this engine or another over the same module).  A CPU engine runs the
bodies eagerly.  Host arrays reach the card through a ring of pinned
buffers with non-blocking copies (:class:`_PinnedRing`), and the token
block comes back the same way (:meth:`copy_to_host_async`), so a
dispatch never waits for the device and an array the scheduler mutates
after a dispatch never reaches the body in flight.  Prefill chunks run
eagerly (ROADMAP.md Queue A5b).

Sampling draws from threefry keys (``serving/sampling/prng.py``), bit
for bit ``jax.random``'s stream: the engine's key, seeded from ``seed``
and split per ``generate`` / ``sample_from_logits`` call as the JAX
engine splits its own, and per-request keys in the policy bodies, where
every knob is a per-slot tensor, so param churn never captures again.
Greedy is an fp32 argmax whose ties go to the lowest token id
(``torch.argmax`` returns the first maximal index).
"""

import dataclasses
import itertools
import os
import time
import weakref

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import gpt2, kv_cache, llama
from deepspeed_tpu_torch.ops import launch_counter
from deepspeed_tpu_torch.ops.attention.decode import paged_kernel_decision
from deepspeed_tpu_torch.ops.quant import kv as kvq
from deepspeed_tpu_torch.ops.quant.quantizer import (dequantize_tree,
                                                     quantize_tree)
from deepspeed_tpu_torch.serving.sampling import pipeline, prng
from deepspeed_tpu_torch.serving.sampling.params import request_key
from deepspeed_tpu_torch.utils.logging import log_dist

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
_PINNED_RING = 8          # host staging buffers in flight, at most
# the static inputs of each captured body, by name; every one is a
# [slots] lane but ``drafts`` [slots, K] and ``page_table`` [slots, maxp].
# ``keep`` is ANDed into ``active`` before the body runs
_DECODE_DTYPES = {"tok": np.int32, "active": np.bool_, "lengths": np.int32,
                  "budgets": np.int32, "eos_ids": np.int32,
                  "emitted": np.int32, "keep": np.bool_,
                  "page_table": np.int32}
_VERIFY_DTYPES = {"tok": np.int32, "drafts": np.int32, "widths": np.int32,
                  "active": np.bool_, "lengths": np.int32,
                  "budgets": np.int32, "eos_ids": np.int32,
                  "emitted": np.int32, "page_table": np.int32}
# the decoding-policy lanes the policy twins add: [slots] but the
# threefry ``keys`` [slots, 2] (uint32 words in int64) and the
# ``counts`` / ``mask`` tables [slots, vocab]
_POLICY_DTYPES = {"keys": np.int64, "tok_base": np.int32,
                  "temps": np.float32, "top_ks": np.int32,
                  "top_ps": np.float32, "rep_pens": np.float32,
                  "pres_pens": np.float32, "freq_pens": np.float32,
                  "counts": np.int32, "mask": np.bool_}
_GRAPH_KINDS = ("decode_multi", "decode_multi_policy", "verify",
                "verify_policy", "copy_page")


def _sample_tokens(logits, rng=None, do_sample=False, temperature=1.0,
                   top_k=0, top_p=1.0):
    """Next token from [batch, vocab] logits (the JAX ``_sample_tokens``,
    ``engine.py:53-81``).  THE greedy contract: ``do_sample=False`` or
    ``temperature == 0`` is an argmax over the fp32 logits, ties to the
    lowest token id, and ``rng`` is not read.  Otherwise temperature,
    top-k and top-p truncate the fp32 logits and one categorical draw
    per row comes from the threefry key ``rng`` ([2]: every row from one
    stream, as JAX draws them)."""
    logits = logits.float()
    if not do_sample or not temperature:
        return torch.argmax(logits, dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    vocab = logits.shape[-1]
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1, descending=True).values[
            :, min(int(top_k), vocab) - 1:min(int(top_k), vocab)]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(pipeline.softmax(sorted_logits), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=vocab - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return prng.categorical(rng, logits)


def _checkpoint_dir(ckpt):
    """The config's ``checkpoint``: a path or ``{"checkpoint_dir": path}``
    (the JAX engine's rule, ``inference/engine.py:180-192``), or None."""
    if ckpt is None:
        return None
    path = ckpt.get("checkpoint_dir") or ckpt.get("base_dir") \
        if isinstance(ckpt, dict) else ckpt
    if not isinstance(path, (str, os.PathLike)):
        raise ValueError(f"unusable checkpoint config: {ckpt!r} (expected "
                         "a path or {'checkpoint_dir': path})")
    return os.fspath(path)


def _materialize(module, device, dtype):
    """Give every parameter of a ``meta`` module uninitialised memory on
    ``device``, floats in ``dtype``.  ``torch.empty`` rather than
    ``Module.to_empty``: ``empty_like`` of a meta tensor imports
    ``torch.fx``'s symbolic shapes, seconds the first time."""
    for m in module.modules():
        for name, p in m._parameters.items():
            if p is not None and p.is_meta:
                m._parameters[name] = torch.nn.Parameter(torch.empty(
                    p.shape, device=device,
                    dtype=dtype if p.is_floating_point() else p.dtype),
                    requires_grad=p.requires_grad)


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


class _PinnedRing:
    """Host arrays to the card with one non-blocking copy from pinned
    memory.  The arrays are packed (16-byte aligned) into one of
    ``depth`` pinned buffers, which is reused only once the event of its
    previous copy has passed: a pageable copy would synchronize the
    stream behind the horizon in flight, and a pinned buffer rewritten
    while its copy is pending would hand the device the scheduler's
    next values (the reference's race, ROADMAP.md Queue C)."""

    def __init__(self, device, depth=_PINNED_RING):
        self.device = device
        self._bufs = [None] * depth
        self._events = [None] * depth
        self._next = 0

    @staticmethod
    def _offsets(arrays):
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // 16) * 16
        return offs, max(total, 16)

    def stage(self, arrays, out=None):
        """numpy ``arrays`` -> ``(buffer, views)``: device tensors, views
        of one uint8 ``buffer`` (``out`` when given: a buffer an earlier
        call returned for arrays of the same shapes and dtypes)."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offs, total = self._offsets(arrays)
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is None:
            self._events[i] = torch.cuda.Event()
        else:
            self._events[i].synchronize()
        host = self._bufs[i]
        if host is None or host.numel() < total:
            host = self._bufs[i] = torch.empty(total, dtype=torch.uint8,
                                               pin_memory=True)
        flat = host.numpy()
        for a, o in zip(arrays, offs):
            flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        if out is None:
            out = torch.empty(total, dtype=torch.uint8, device=self.device)
        out[:total].copy_(host[:total], non_blocking=True)
        self._events[i].record()
        return out, [out[o:o + a.nbytes].view(_torch_dtype(a.dtype))
                     .reshape(a.shape) for a, o in zip(arrays, offs)]


class HostCopy:
    """Device tensors on their way to the host: pinned buffers filled by
    non-blocking copies and an event (the JAX ``copy_to_host_async``).
    :meth:`wait` blocks on the event and returns numpy arrays."""

    def __init__(self, tensors):
        if tensors[0].device.type == "cpu":
            self._host, self._event = list(tensors), None
            return
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in tensors]
        for h, t in zip(self._host, tensors):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class _BodyGraph:
    """A serving body — ``decode_multi``'s horizon loop or
    ``verify_multi``'s round — for one (pools, bucket, slot count, page
    table width), captured once as a CUDA graph over static inputs: views
    of one device buffer the pinned ring fills in a single copy
    (``shapes``: name -> (shape, numpy dtype)).  The graph replays the
    raw addresses of the pools and weights but holds neither: the engine
    drops it before either is freed or replaced."""

    def __init__(self, engine, body, pools, shapes):
        dev = engine.device
        zeros = [np.zeros(shape, dt) for shape, dt in shapes.values()]
        self.buffer, views = engine._ring.stage(zeros)
        self.inputs = dict(zip(shapes, views))
        args = {k: v for k, v in self.inputs.items() if k != "keep"}
        # warm-up, eager on a side stream: every slot inactive, so the
        # pools see writes to the sink page only; it also builds and
        # loads the kernels and runs their first-use set-up, none of
        # which may happen under capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(pools, **args)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with launch_counter.recording() as self.launches, \
                torch.cuda.graph(self.graph):
            self.outputs = body(pools, **args)

    def replay(self):
        """Run the captured body on the current stream and copy its
        outputs out of the static buffers (in stream order), so the next
        replay cannot overwrite a block not yet harvested."""
        self.graph.replay()
        launch_counter.replay(self.launches)
        return tuple(t.clone() for t in self.outputs)


class InferenceEngine:
    """Wraps a ``Llama`` or ``GPT2`` module for generation and paged
    serving.  Both keep their caches in ``models/kv_cache.py``'s layout
    (the JAX engine's ``_supports_cache`` / ``_paged_module``,
    ``engine.py:620-700``)."""

    def __init__(self, model, config, params=None, seed=0):
        if not isinstance(model, (llama.Llama, gpt2.GPT2)):
            raise NotImplementedError(
                f"the PyTorch package serves a native Llama or GPT2 (the "
                f"GPT-2 family), got {type(model).__name__}: pass an HF "
                "model or a save_pretrained directory to init_inference, "
                "which ingests it (module_inject.from_hf)")
        self._config = config
        self.device = resolve_device(config.device)
        if config.paged_kernel == "force" and self.device.type != "cuda":
            raise ValueError("paged_kernel='force' needs the kernels, which "
                             "run only on a CUDA device")
        if config.enable_cuda_graph and self.device.type != "cuda":
            raise ValueError("enable_cuda_graph=True needs a CUDA device: "
                             "a CPU engine runs the decode loop eagerly")
        self.cuda_graphs = self.device.type == "cuda" and \
            config.enable_cuda_graph is not False
        self._graphs = {}          # pool key -> {(body, bucket, ...): graph}
        self._graph_weights = None  # the weights the graphs were captured over
        self._captures = dict.fromkeys(_GRAPH_KINDS, 0)
        self._capture_s = dict.fromkeys(_GRAPH_KINDS, 0.0)
        self._ring = _PinnedRing(self.device) \
            if self.device.type == "cuda" else None
        self.dtype = DTYPES[config.dtype]
        # a torch dtype (float pools) or the quantized kv-dtype NAME
        # ("int8" / "fp8": payload pools + per-row f32 scale pools,
        # ops/quant/kv.py); fp8 support is validated here, not at the
        # first serving dispatch
        self.kv_dtype = self._resolve_kv_dtype(config.kv_cache_dtype)
        self.seed = int(seed)
        ckpt = _checkpoint_dir(config.checkpoint)
        empty = any(p.is_meta for p in model.parameters())
        if empty:
            # an ingested module (module_inject.from_hf) holds no memory
            # yet: allocate it on the device in the compute dtype, for
            # the weights about to be loaded
            if params is None and ckpt is None:
                raise ValueError("a module on the meta device needs params= "
                                 "or checkpoint= to fill it")
            _materialize(model, self.device, self.dtype)
        # the engine's threefry key (``jax.random.PRNGKey(seed)``), split
        # per generate() / sample_from_logits() call as the JAX engine
        # splits its own
        self._rng = prng.as_key(request_key(self.seed))
        if config.replace_with_kernel_inject and \
                model.cfg.attn_impl != "auto":
            # a fresh module (never the caller's, which may be live
            # elsewhere) with the caller's weights and attn_impl "auto"
            fresh = type(model)(dataclasses.replace(model.cfg,
                                                    attn_impl="auto"),
                                device="meta").to_empty(device=self.device)
            fresh.load_state_dict(model.state_dict())
            model = fresh
        self.module = model.to(device=self.device).eval()
        self.module.requires_grad_(False)
        # the submodules that own tensors: the weights a graph reads
        self._weight_owners = [m for m in self.module.modules()
                               if m._parameters or m._buffers]
        if not config.quant.enabled and any(
                getattr(m, "quantized", False) for m in model.modules()):
            raise ValueError(
                "the module holds int8 weights but the config's quant "
                "section is off: pass dtype='int8' or quant={'enabled': "
                "True}, or dequantize_tree(module) first")
        # the module arrives with weights: cast them to the compute dtype
        # and quantize them if the config says so
        self._cast_params()
        if config.quant.enabled and not empty:
            self._postprocess_params()
        # a checkpoint to load replaces the params (the JAX engine's
        # order, inference/engine.py:193-199)
        if params is not None and ckpt is None:
            self.set_params(params)
        if ckpt is not None:
            self.load_checkpoint(ckpt)

    # ------------------------------------------------------------ params
    @torch.no_grad()
    def _cast_params(self):
        """Float parameters to the compute dtype.  Quantized layers keep
        their int8 payload and float32 scales and compute in it."""
        for p in self.module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(self.dtype)
        for m in self.module.modules():
            if getattr(m, "quantized", False):
                m.qdtype = self.dtype

    @torch.no_grad()
    def init_params(self, seed=None, quantize=None):
        """Random weights from a seeded ``torch.Generator`` on the engine's
        device: normal(0, 0.02) projections and embeddings, ones for the
        norms — the flax initializers of the JAX model.  Then quantized
        as :meth:`set_params` does."""
        dequantize_tree(self.module)      # float weights to draw into
        self._cast_params()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed if seed is None else int(seed))
        if isinstance(self.module, gpt2.GPT2):
            gpt2.init_gpt2_params(self.module, gen)
            return self._postprocess_params(quantize=quantize)
        for name, p in self.module.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        return self._postprocess_params(quantize=quantize)

    @torch.no_grad()
    def set_params(self, state_dict, quantize=None):
        """Load a float ``state_dict`` (tensors or numpy arrays), cast to
        the engine's dtype and placed on its device; with ``quant.enabled``
        every ``QDense`` weight then quantizes to int8 groups
        (``engine.py:352-373`` of the JAX package).  ``quantize=False``
        keeps floats."""
        dequantize_tree(self.module)
        self._cast_params()
        self._load_leaves(state_dict)
        return self._postprocess_params(quantize=quantize)

    @torch.no_grad()
    def _load_leaves(self, state_dict):
        """Copy ``state_dict`` into the module one leaf at a time: each is
        read (a lazy mapping builds it here), cast to the parameter's
        dtype and placed on its device before the next is read.  The
        names must be exactly the module's, the shapes its shapes."""
        own = self.module.state_dict()
        missing = sorted(set(own) - set(state_dict))
        extra = sorted(set(state_dict) - set(own))
        if missing or extra:
            raise RuntimeError(f"state_dict does not match the module: "
                               f"missing={missing[:5]} unexpected="
                               f"{extra[:5]}")
        for name, dst in own.items():
            src = torch.as_tensor(state_dict[name])
            if tuple(src.shape) != tuple(dst.shape):
                raise RuntimeError(f"size mismatch for {name}: "
                                   f"{tuple(src.shape)} vs the module's "
                                   f"{tuple(dst.shape)}")
            if src.device != dst.device and src.dtype != dst.dtype:
                # move the file's bytes as they are, cast on the device
                src = src.to(dst.device)
            dst.copy_(src)

    @torch.no_grad()
    def load_checkpoint(self, path, tag=None):
        """Serve the weights of a training checkpoint written by either
        package (the JAX ``load_checkpoint``, ``:512-580``): the ``.params``
        leaves under their JAX names (``checkpoint/params.py``), read
        through the config's ``checkpoint_engine``, placed leaf by leaf,
        then quantized as :meth:`set_params` does.  ``tag`` defaults to
        the directory's ``latest`` file, else ``path`` is the tag
        directory itself."""
        from deepspeed_tpu_torch.checkpoint.backend import \
            get_checkpoint_engine
        from deepspeed_tpu_torch.checkpoint.params import (PARAMS,
                                                           jax_leaf_names)
        backend = get_checkpoint_engine(self._config.checkpoint_engine)
        path = os.fspath(path)
        if tag is None:
            latest = os.path.join(path, "latest")
            if os.path.exists(latest):
                with open(latest) as f:
                    tag = f.read().strip()
        full = os.path.join(path, str(tag)) if tag else path
        dequantize_tree(self.module)
        self._cast_params()
        own = self.module.state_dict()
        names = jax_leaf_names(self.module)
        target = {leaf: tuple(own[n].shape)[::-1] if tr
                  else tuple(own[n].shape) for n, (leaf, tr) in names.items()}
        loaded = backend.load_subtree(full, target, prefix=PARAMS)
        for name, (leaf, transposed) in names.items():
            src = loaded.pop(leaf)
            own[name].copy_(src.t() if transposed else src)
        log_dist(f"inference checkpoint loaded from {full}", ranks=[0])
        return self._postprocess_params()

    @torch.no_grad()
    def _postprocess_params(self, quantize=None):
        """Quantize the module's float ``QDense`` weights per the config,
        layer by layer on the engine's device (peak: the float model plus
        one layer).  The JAX leaf predicate is ``"kernel" in path``
        (``engine.py:452-455``): every ``QDense`` — wq/wk/wv/wo,
        w_gate/w_up/w_down and ``lm_head`` — and never ``embed_tokens``
        or the norms; the sweep here visits exactly the ``QDense``
        layers."""
        qcfg = self._config.quant
        quantize = qcfg.enabled if quantize is None else quantize
        if quantize:
            quantize_tree(self.module, bits=qcfg.num_bits,
                          group_size=qcfg.group_size)
        n = sum(p.numel() for p in self.module.parameters()) + \
            sum(m.q.numel() for m in self.module.modules()
                if getattr(m, "quantized", False))
        log_dist(f"inference params ready: {n / 1e6:.1f}M, dtype="
                 f"{self._config.dtype}{' +int8' if quantize else ''}, "
                 f"device={self.device}", ranks=[0])
        return self

    @property
    def weight_dtype_name(self):
        """Canonical weight-storage dtype for operator surfaces: "int8"
        under weight-only quantization, else the compute dtype name."""
        return "int8" if self._config.quant.enabled else self._config.dtype

    # ----------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, input_ids):
        """Full causal forward -> logits [b, l, vocab] (no cache)."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
        return self.module(ids.long())

    __call__ = forward

    # ---------------------------------------------------------- generate
    def _next_key(self):
        """``self._rng, rng = jax.random.split(self._rng)``: a fresh key
        on the engine's device."""
        self._rng, rng = prng.split(self._rng)
        return rng.to(self.device)

    def _rows(self, logits):
        if isinstance(logits, (list, tuple)):
            rows = torch.stack([torch.as_tensor(r) for r in logits])
        else:
            rows = torch.as_tensor(logits)
        single = rows.ndim == 1
        return (rows[None] if single else rows).to(self.device), single

    def sample_from_logits(self, logits, do_sample=False, temperature=1.0,
                           top_k=0, top_p=1.0):
        """Next token(s) under ``_sample_tokens``: a [vocab] row returns
        an int, a list of rows or an [n, vocab] batch returns a list (one
        device call).  Every call splits the engine's key, as the JAX
        engine's does; a sampled batch draws all its rows from that one
        key, so batching changes a sampled stream (greedy is
        unaffected)."""
        rows, single = self._rows(logits)
        toks = _sample_tokens(rows, self._next_key(), do_sample, temperature,
                              top_k, top_p).tolist()
        return toks[0] if single else toks

    @torch.no_grad()
    def sample_from_logits_policy(self, logits, keys, tok_idx, temps,
                                  top_ks, top_ps, rep_pens, pres_pens,
                                  freq_pens, counts, mask):
        """Boundary sampling under the decoding policy (the JAX
        ``engine.py:1713-1756``): ``logits`` is a list of [vocab] rows or
        an [n, vocab] batch, every other argument per row (host arrays).
        Row ``r`` draws from ``fold_in(keys[r], tok_idx[r])``, the
        position-keyed stream the policy horizons use, so the first token
        does not depend on batching, preemption or the horizon."""
        rows, single = self._rows(logits)

        def dev(x, dt):
            return torch.as_tensor(np.asarray(x, dt), device=self.device)
        x = pipeline.process_logits(
            rows, dev(counts, np.int32), dev(mask, np.bool_),
            dev(temps, np.float32), dev(top_ks, np.int32),
            dev(top_ps, np.float32), dev(rep_pens, np.float32),
            dev(pres_pens, np.float32), dev(freq_pens, np.float32))
        toks = pipeline.sample_processed(
            x, dev(np.asarray(keys, np.uint32).reshape(-1, 2), np.int64),
            dev(tok_idx, np.int64), dev(temps, np.float32)).tolist()
        return toks[0] if single else toks

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None):
        """Generation over a dense KV cache, greedy or sampled
        (``_sample_tokens``).  Returns the prompt followed by the new
        tokens, as a numpy array [b, len]; rows that emitted
        ``eos_token_id`` continue with it as fill.  The cache length
        rounds up to 128 positions (``engine.py:1855-1862``).  The keys
        are the JAX engine's: one split for the first token, one more for
        the rest, whose step ``i`` draws from ``fold_in(rng, i)``; the
        tokens are those of the JAX package's bucketed scan, which only
        runs extra steps past the returned ones."""
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        b, prompt_len = ids.shape
        if max_new_tokens == 0:
            return ids
        max_len = prompt_len + max_new_tokens
        if max_len > self._config.max_out_tokens:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_out_tokens={self._config.max_out_tokens}; "
                "raise max_out_tokens in the inference config")
        policy = dict(do_sample=do_sample, temperature=temperature,
                      top_k=top_k, top_p=top_p)
        bucket = 128
        cache_len = min(-(-max_len // bucket) * bucket,
                        self._config.max_out_tokens)
        # a quantized kv dtype applies to the PAGED pools only: the dense
        # cache is float32 then, because generate() is the oracle the
        # quantized serving path is measured against
        cache_dtype = torch.float32 if kvq.is_quantized_kv(self.kv_dtype) \
            else self.kv_dtype
        cache = kv_cache.init_kv_cache(
            self.module.cfg, b, max_len=cache_len, dtype=cache_dtype,
            device=self.device)
        logits, cache = self.module(
            torch.as_tensor(ids, device=self.device).long(), cache=cache)
        tok = _sample_tokens(logits[:, -1], self._next_key(), **policy)
        toks = [tok]
        finished = torch.zeros(b, dtype=torch.bool, device=self.device)
        if eos_token_id is not None:
            finished |= tok == eos_token_id
        rng = self._next_key() if max_new_tokens > 1 else None
        for i in range(max_new_tokens - 1):
            logits, cache = self.module(tok[:, None], cache=cache)
            nxt = _sample_tokens(
                logits[:, 0], None if not do_sample or not temperature
                else prng.fold_in(rng, i), **policy)
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
                finished |= nxt == eos_token_id
            tok = nxt
            toks.append(tok)
        gen = torch.stack(toks, dim=1).cpu().numpy().astype(ids.dtype)
        return np.concatenate([ids, gen], axis=1)

    # ------------------------------------------------------ paged serving
    def _resolve_kv_dtype(self, kv_dtype=None):
        """``None`` (the engine's), a torch dtype, a float name or a
        quantized name -> a torch dtype or "int8" / "fp8"."""
        dt = self.kv_dtype if kv_dtype is None else kv_dtype
        if isinstance(dt, str):
            if dt in DTYPES:
                dt = DTYPES[dt]
            elif dt in kvq.KV_QUANT_DTYPES:
                kvq.kv_storage_dtype(dt)      # fp8 runtime gate
            else:
                raise ValueError(
                    f"unsupported kv_dtype {dt!r}; pick one of "
                    f"{sorted(DTYPES) + sorted(kvq.KV_QUANT_DTYPES)}")
        return dt

    def paged_kernel_decision(self, pools=None, kv_dtype=None):
        """The paged-attention dispatch decision for this engine's device
        and model (``ops/attention/decode.paged_kernel_decision``) over
        the live ``pools`` when given, else over a pool of ``kv_dtype``
        (default: the engine's).  Float pools attend in their own dtype;
        quantized pools dequantize to the compute dtype."""
        cfg = self.module.cfg
        if pools is not None:
            layer = pools["layers"][0]
            storage = layer["k_pages"].dtype
            quantized = "k_scale" in layer
        else:
            dt = self._resolve_kv_dtype(kv_dtype)
            quantized = kvq.is_quantized_kv(dt)
            storage = kvq.kv_storage_dtype(dt) if quantized else dt
        return paged_kernel_decision(
            device_type=self.device.type, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            dtype=self.dtype if quantized else storage,
            storage_dtype=storage if quantized else None,
            has_bias=getattr(cfg, "use_alibi", False))

    def init_paged_cache(self, num_pages, page_size, kv_dtype=None):
        """Per-layer K/V page pools on the engine's device (each holds
        ``num_pages`` pages plus the drop sink, ``ops/quant/kv.py``).
        ``kv_dtype`` overrides the engine's configured kv_cache_dtype for
        THIS pool: a torch dtype, a float name or a quantized name
        ("int8" / "fp8" — the pools then carry f32 scale leaves)."""
        cfg = self.module.cfg
        if any(getattr(cfg, "attn_windows", ())):
            raise NotImplementedError(gpt2.PAGED_WINDOWS_REFUSED)
        dt = self._resolve_kv_dtype(kv_dtype)
        dec = self.paged_kernel_decision(kv_dtype=dt)
        if dec["path"] == "unsupported":
            raise ValueError(dec["reason"])
        log_dist(f"paged attention path: {dec['path']} — {dec['reason']}",
                 ranks=[0])
        return kv_cache.init_paged_kv_cache(cfg, num_pages, page_size,
                                            dtype=dt, device=self.device)

    def kv_page_bytes(self, page_size, kv_dtype=None):
        """Exact bytes ONE paged-KV page costs across all layers (K + V
        payload + the f32 scale rows of a quantized pool); agrees with
        the allocated leaves to the byte."""
        cfg = self.module.cfg
        return kvq.kv_page_bytes(cfg.num_layers, cfg.num_kv_heads,
                                 cfg.head_dim, page_size,
                                 self._resolve_kv_dtype(kv_dtype))

    def _stage(self, x, dtype):
        """Host array (or a carry already on the device) -> device tensor.
        A host array is copied (on a CUDA engine through the pinned ring),
        never aliased: the scheduler mutates its arrays after a call."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        x = np.asarray(x)
        if self._ring is None:
            return torch.tensor(x, dtype=dtype)
        return self._ring.stage([x])[1][0].to(dtype)

    @torch.no_grad()
    def prefill_into_slots(self, ids_chunk, slot, n_valid, page_table,
                           lengths, pools):
        """One prefill chunk of one slot: write the chunk's K/V through the
        page table (pages covering lengths[slot] .. +n_valid must be
        allocated) and return (boundary logits [vocab], pools).
        ``ids_chunk`` is [1, chunk], padded past ``n_valid``."""
        cache = dict(pools, page_table=self._stage(page_table, torch.int32),
                     lengths=self._stage(lengths, torch.int32),
                     slot=int(slot), n_valid=int(n_valid))
        logits, _ = self.module(self._stage(ids_chunk, torch.long),
                                cache=cache)
        return logits[0, 0], pools

    @torch.no_grad()
    def decode_step(self, toks, active, page_table, lengths, pools,
                    do_sample=False, temperature=1.0, top_k=0, top_p=1.0):
        """One decode step over ALL slots: write each active slot's token
        K/V at position lengths[slot], attend through the page table and
        return (next tokens [slots] int32 on the device, pools).  Tokens
        come from ``_sample_tokens`` on a split of the engine's key."""
        cache = dict(pools, page_table=self._stage(page_table, torch.int32),
                     lengths=self._stage(lengths, torch.int32),
                     active=self._stage(active, torch.bool))
        logits, _ = self.module(self._stage(toks, torch.long)[:, None],
                                cache=cache)
        return _sample_tokens(logits[:, 0], self._next_key(), do_sample,
                              temperature, top_k, top_p).to(
                                  torch.int32), pools

    @torch.no_grad()
    def decode_multi(self, toks, active, page_table, lengths, pools, *,
                     horizon, budgets, eos_ids, emitted=None, keep=None):
        """``horizon`` greedy decode steps over all slots with the
        feedback on the device.  Returns ``(toks_block [slots, H], valid
        [slots, H], tok_end, active_end, lengths_end, emitted_end,
        pools)``, all device tensors.  A slot freezes after sampling
        ``eos_ids[slot]`` (-1 = none) or once its ``emitted`` count
        reaches ``budgets[slot]``; frozen slots write no K/V (the sink
        takes their rows), advance no length and emit ``valid=False``
        rows — the JAX ``decode_multi`` rules (``engine.py:829-873``).
        ``keep`` (host bool [slots]) is ANDed into ``active`` on the
        device: a chained dispatch freezes the slots the host has closed
        since.  Sampled serving runs :meth:`decode_multi_policy`.

        Each input is a host array or a device tensor (a chained
        dispatch passes the previous horizon's carries).  On a CUDA
        engine with graphs the horizon replays the graph of its bucket
        (:meth:`serving_decode_multi_capture_count`); the outputs are
        fresh tensors, never the graph's static buffers."""
        return self._decode(toks, active, page_table, lengths, pools,
                            horizon, budgets, eos_ids, emitted, keep, None)

    @torch.no_grad()
    def decode_multi_policy(self, toks, active, page_table, lengths, pools,
                            *, horizon, budgets, eos_ids, keys, tok_base,
                            temps, top_ks, top_ps, rep_pens, pres_pens,
                            freq_pens, counts, mask, emitted=None,
                            keep=None):
        """:meth:`decode_multi` under the per-slot decoding policy (the
        JAX ``engine.py:940-985`` / ``:1619-1665``): each step runs the
        ``serving/sampling/pipeline.py`` chain over the slot's lanes and
        draws token ``tok_base[s] + emitted[s]`` of the slot's stream from
        ``keys[s]`` ([slots, 2] threefry words).  ``counts`` [slots,
        vocab] (the penalties' token counts) rides the carry, so a
        penalty sees the tokens sampled earlier in the horizon; ``mask``
        [slots, vocab] is the grammar mask.  Returns the decode tuple
        with ``counts_end`` before the pools.  ``counts`` is a host array
        at a barrier or the previous horizon's ``counts_end`` in a chain.
        Every knob is a graph input: one graph (kind
        ``"decode_multi_policy"``) per horizon bucket whatever the mix."""
        policy = dict(keys=keys, tok_base=tok_base, temps=temps,
                      top_ks=top_ks, top_ps=top_ps, rep_pens=rep_pens,
                      pres_pens=pres_pens, freq_pens=freq_pens,
                      counts=counts, mask=mask)
        return self._decode(toks, active, page_table, lengths, pools,
                            horizon, budgets, eos_ids, emitted, keep, policy)

    def _shapes(self, base, slots, extra=None, policy=False):
        """Input shapes of a body: [slots] lanes, ``page_table`` and any
        ``extra`` (name -> shape), and the policy lanes when asked."""
        dtypes = dict(base, **(_POLICY_DTYPES if policy else {}))
        vocab = self.module.cfg.vocab_size
        special = dict(keys=(slots, 2), counts=(slots, vocab),
                       mask=(slots, vocab), **(extra or {}))
        return {k: (special.get(k, (slots,)), dt)
                for k, dt in dtypes.items()}

    def _decode(self, toks, active, page_table, lengths, pools, horizon,
                budgets, eos_ids, emitted, keep, policy):
        horizon = int(horizon)
        slots = len(budgets)
        values = {"tok": toks, "active": active, "lengths": lengths,
                  "budgets": budgets, "eos_ids": eos_ids,
                  "emitted": np.zeros(slots, np.int32) if emitted is None
                  else emitted,
                  "keep": np.ones(slots, bool) if keep is None else keep,
                  "page_table": page_table, **(policy or {})}
        max_pages = np.shape(page_table)[1]
        shapes = self._shapes(_DECODE_DTYPES, slots,
                              {"page_table": (slots, max_pages)},
                              policy is not None)
        graph, inputs = self._inputs(
            "decode_multi" if policy is None else "decode_multi_policy",
            (horizon, slots, max_pages), shapes, values, pools,
            lambda p, **kw: self._decode_body(p, horizon, **kw))
        mask = inputs.pop("keep")
        if graph is not None:
            if keep is not None:     # the static buffer, in place
                inputs["active"].logical_and_(mask)
            return graph.replay() + (pools,)
        if keep is not None:         # never in place: it may be a carry
            inputs["active"] = inputs["active"] & mask
        return self._decode_body(pools, horizon, **inputs) + (pools,)

    def _inputs(self, kind, bucket, shapes, values, pools, body):
        """The device inputs of one ``kind`` dispatch and the graph to
        replay over them (None when the body runs eagerly).  A CPU engine
        stages each array; a CUDA engine packs the host arrays into one
        pinned copy (into the graph's static buffer, or a fresh one),
        then copies device carries device to device, in stream order
        after it."""
        if self._ring is None:
            return None, {
                k: self._stage(v if isinstance(v, torch.Tensor)
                               else np.asarray(v, shapes[k][1]),
                               _torch_dtype(shapes[k][1]))
                for k, v in values.items()}
        graph = self._graph(kind, bucket, shapes, pools, body) \
            if self.cuda_graphs else None
        names = list(shapes)
        host = [np.zeros(shapes[k][0], shapes[k][1])
                if isinstance(values[k], torch.Tensor)
                else np.asarray(values[k], shapes[k][1]) for k in names]
        _, views = self._ring.stage(
            host, out=None if graph is None else graph.buffer)
        inputs = dict(zip(names, views))
        for k in names:
            if isinstance(values[k], torch.Tensor):
                inputs[k].copy_(values[k])
        return graph, inputs

    def _decode_body(self, pools, horizon, *, tok, active, lengths,
                     budgets, eos_ids, emitted, page_table, **policy):
        """The horizon loop (the JAX scan body): device tensors in, the
        six outputs of :meth:`decode_multi` out (seven with ``counts_end``
        under a ``policy``); no host sync."""
        out_toks, out_valid = [], []
        counts = policy["counts"].clone() if policy else None
        rows = torch.arange(tok.shape[0], device=tok.device)
        for _ in range(horizon):
            cache = dict(pools, page_table=page_table, lengths=lengths,
                         active=active)
            logits, cache = self.module(tok.long()[:, None], cache=cache)
            if policy:
                x = self._process(logits[:, 0], counts, policy)
                nxt = pipeline.sample_processed(
                    x, policy["keys"],
                    policy["tok_base"].long() + emitted.long(),
                    policy["temps"]).to(torch.int32)
            else:
                nxt = _sample_tokens(logits[:, 0]).to(torch.int32)
            nxt = torch.where(active, nxt, tok)
            if policy:
                counts.index_put_((rows, nxt.long()),
                                  active.to(torch.int32), accumulate=True)
            emitted = emitted + active.to(torch.int32)
            out_toks.append(nxt)
            out_valid.append(active)
            lengths = cache["lengths"]
            active = active & (nxt != eos_ids) & (emitted < budgets)
            tok = nxt
        out = (torch.stack(out_toks, 1), torch.stack(out_valid, 1), tok,
               active, lengths, emitted)
        return out + (counts,) if policy else out

    @staticmethod
    def _process(logits, counts, policy):
        return pipeline.process_logits(
            logits, counts, policy["mask"], policy["temps"],
            policy["top_ks"], policy["top_ps"], policy["rep_pens"],
            policy["pres_pens"], policy["freq_pens"])

    @torch.no_grad()
    def verify_multi(self, toks, drafts, active, page_table, lengths, pools,
                     *, widths, budgets, eos_ids, emitted=None):
        """Speculative verification: score ``drafts`` [slots, K] proposed
        tokens per slot in ONE teacher-forced forward over the paged
        cache, accept the longest greedy-matching prefix plus the target
        model's one bonus / correction token (``engine.py:1550-1600`` of
        the JAX package).

        ``widths[s] <= K`` is the real draft count of slot ``s`` (the
        rest of the row is padding); pages covering positions
        ``lengths[s] .. lengths[s] + widths[s]`` must be allocated.
        Greedy: acceptance replays the fp32-argmax contract of
        ``sample_from_logits``, so the stream is token-exact against
        ``generate()`` whatever the drafts (sampled verification is
        :meth:`verify_multi_policy`).

        Returns ``(toks_block [slots, K+1], valid [slots, K+1], tok_end,
        active_end, lengths_end, emitted_end, accepted [slots], pools)``,
        device tensors (int32 / bool).  The carries mean what
        ``decode_multi``'s do: ``lengths_end`` counts emitted tokens only
        (the host mirrors the KV rollback with
        ``PagedKVManager.truncate_slot``; positions past it hold K/V of
        rejected drafts, overwritten before any later read), and a slot
        freezes at EOS or at its budget.  On a CUDA engine with graphs
        the round replays the graph of its (pools, K, slots, table width)
        (:meth:`serving_verify_capture_count`)."""
        return self._verify(toks, drafts, active, page_table, lengths,
                            pools, widths, budgets, eos_ids, emitted, None)

    @torch.no_grad()
    def verify_multi_policy(self, toks, drafts, active, page_table,
                            lengths, pools, *, widths, budgets, eos_ids,
                            keys, tok_base, temps, top_ks, top_ps,
                            rep_pens, pres_pens, freq_pens, counts, mask,
                            emitted=None):
        """Lossless speculative verification under the decoding policy
        (the JAX ``engine.py:986-1063`` / ``:1667-1711``): the same
        teacher-forced forward as :meth:`verify_multi`, then per column
        ``j`` the policy chain and leftover-probability rejection
        sampling (``pipeline.accept_or_resample``) on sub-streams of
        ``fold_in(key, tok_base + j)``; a greedy row keeps the exact
        argmax rule.  ``counts`` carries the accepted drafts so the
        penalties stay causal within the round.  Returns the verify
        tuple with ``counts_end`` before the pools; one graph (kind
        ``"verify_policy"``) per K bucket."""
        policy = dict(keys=keys, tok_base=tok_base, temps=temps,
                      top_ks=top_ks, top_ps=top_ps, rep_pens=rep_pens,
                      pres_pens=pres_pens, freq_pens=freq_pens,
                      counts=counts, mask=mask)
        return self._verify(toks, drafts, active, page_table, lengths,
                            pools, widths, budgets, eos_ids, emitted, policy)

    def _verify(self, toks, drafts, active, page_table, lengths, pools,
                widths, budgets, eos_ids, emitted, policy):
        slots, k = np.shape(drafts)
        values = {"tok": toks, "drafts": drafts, "widths": widths,
                  "active": active, "lengths": lengths, "budgets": budgets,
                  "eos_ids": eos_ids,
                  "emitted": np.zeros(slots, np.int32) if emitted is None
                  else emitted, "page_table": page_table, **(policy or {})}
        max_pages = np.shape(page_table)[1]
        shapes = self._shapes(_VERIFY_DTYPES, slots,
                              {"drafts": (slots, k),
                               "page_table": (slots, max_pages)},
                              policy is not None)
        graph, inputs = self._inputs(
            "verify" if policy is None else "verify_policy",
            (k, slots, max_pages), shapes, values, pools, self._verify_body)
        if graph is not None:
            return graph.replay() + (pools,)
        return self._verify_body(pools, **inputs) + (pools,)

    def _verify_body(self, pools, *, tok, drafts, widths, active, lengths,
                     budgets, eos_ids, emitted, page_table, **policy):
        """One verify round (``engine.py:875-941`` of the JAX package,
        ``:986-1063`` under a ``policy``): device tensors in, the seven
        outputs of :meth:`verify_multi` out (eight with ``counts_end``
        under a policy); no host sync."""
        slots, k = drafts.shape
        dev = drafts.device
        i32 = torch.int32
        cache = dict(pools, page_table=page_table, lengths=lengths,
                     active=active,
                     widths=torch.where(active, widths + 1, 0).to(i32))
        x = torch.cat([tok[:, None], drafts], dim=1).long()
        logits, _ = self.module(x, cache=cache)
        drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], 1)
        if policy:
            a, bonus, counts = self._accept_policy(logits, drafts_pad,
                                                   widths, active, policy)
            bonus = bonus[:, None]
        else:
            # the greedy contract: fp32 argmax, ties to the lowest id
            g = _sample_tokens(logits).to(i32)               # [slots, K+1]
            jk = torch.arange(k, device=dev)
            ok = (drafts == g[:, :k]) & (jk[None, :] < widths[:, None])
            a = torch.cumprod(ok.to(i32), dim=1).sum(dim=1).to(i32)
            bonus = torch.gather(g, 1, a[:, None].long())
        jw = torch.arange(k + 1, device=dev)
        # emitted stream: accepted drafts, then the bonus token
        out_toks = torch.where(jw[None, :] < a[:, None], drafts_pad, bonus)
        is_eos = (out_toks == eos_ids[:, None]) & (eos_ids[:, None] >= 0)
        has_eos = is_eos.any(dim=1)
        n_eos = torch.where(has_eos, is_eos.to(i32).argmax(dim=1) + 1,
                            k + 2).to(i32)
        n = torch.minimum(torch.minimum(a + 1, n_eos),
                          (budgets - emitted).clamp(min=0))
        n = torch.where(active, n, 0).to(i32)
        valid = jw[None, :] < n[:, None]
        emitted_end = emitted + n
        last = torch.gather(out_toks, 1,
                            (n - 1).clamp(min=0)[:, None].long())[:, 0]
        tok_end = torch.where(n > 0, last, tok)
        active_end = active & ~(has_eos & (n_eos <= n)) & \
            (emitted_end < budgets)
        out = (out_toks, valid, tok_end, active_end, lengths + n,
               emitted_end, torch.minimum(a, n))
        return out + (counts,) if policy else out

    def _accept_policy(self, logits, drafts_pad, widths, active, policy):
        """The column scan of the JAX ``verify_multi_policy``: per column
        the policy chain, the draft's accept-or-resample and the bonus
        draw; returns (accepted count, the token after them, counts)."""
        slots = drafts_pad.shape[0]
        rows = torch.arange(slots, device=drafts_pad.device)
        counts = policy["counts"].clone()
        keys, temps = policy["keys"], policy["temps"]
        base = policy["tok_base"].long()
        accepting = active
        acc = torch.zeros(slots, dtype=torch.int32, device=rows.device)
        bonus = torch.zeros_like(acc)
        for j in range(drafts_pad.shape[1]):
            lg = self._process(logits[:, j], counts, policy)
            d = drafts_pad[:, j]
            is_draft = (j < widths) & accepting
            is_bonus = (j == widths) & accepting
            accept_col, fallback = pipeline.accept_or_resample(
                lg, d, keys, base + j, temps)
            bonus_col = pipeline.bonus_sample(lg, keys, base + j, temps)
            draft_accept = is_draft & accept_col
            reject_now = is_draft & ~accept_col
            bonus = torch.where(reject_now, fallback,
                                torch.where(is_bonus, bonus_col, bonus))
            counts.index_put_((rows, d.long()), draft_accept.to(torch.int32),
                              accumulate=True)
            acc = acc + draft_accept.to(torch.int32)
            accepting = draft_accept
        return acc, bonus, counts

    @torch.no_grad()
    def copy_page(self, pools, src_page, dst_page):
        """Copy ONE KV page in place across every leaf of every layer's
        pool (the prefix cache's copy-on-write, the JAX
        ``engine.py:1117-1147``): a quantized pool's scale rows move with
        their payload under the same page id, or the private copy would
        dequantize with the wrong scales.  The page ids are device int32
        scalars, so which pages are copied never captures a new graph:
        a CUDA engine replays one graph (kind ``"copy_page"``) per pool
        set.  Returns the same ``pools`` object."""
        shapes = {"src": ((1,), np.int32), "dst": ((1,), np.int32)}
        values = {"src": np.array([src_page], np.int32),
                  "dst": np.array([dst_page], np.int32)}
        graph, inputs = self._inputs("copy_page", (), shapes, values, pools,
                                     self._copy_page_body)
        if graph is not None:
            graph.replay()
        else:
            self._copy_page_body(pools, **inputs)
        return pools

    @staticmethod
    def _copy_page_body(pools, *, src, dst):
        src, dst = src.long(), dst.long()
        for layer in pools["layers"]:
            for t in layer.values():
                raw = t.view(torch.uint8)    # bit for bit, any dtype
                raw.index_copy_(0, dst, raw.index_select(0, src))
        return ()

    def _graph(self, kind, bucket, shapes, pools, body):
        """The cached graph of ``kind`` for this bucket over these pools,
        captured on first use.  A recast, dequantized or re-quantized
        weight (from any engine over this module) drops every graph; a
        pool set's graphs go when the first of its leaves is freed,
        before the allocator can hand that address to another tensor."""
        weights = tuple((t.data_ptr(), t.dtype)
                        for m in self._weight_owners
                        for t in itertools.chain(m._parameters.values(),
                                                 m._buffers.values())
                        if t is not None)
        if weights != self._graph_weights:
            self._graphs.clear()
            self._graph_weights = weights
        leaves = [t for layer in pools["layers"] for t in layer.values()]
        key = tuple(t.data_ptr() for t in leaves)
        graphs = self._graphs.get(key)
        if graphs is None:
            graphs = self._graphs[key] = {}
            for t in leaves:
                weakref.finalize(t, self._graphs.pop, key, None)
        if (kind, bucket) not in graphs:
            t0 = time.monotonic()
            graphs[(kind, bucket)] = _BodyGraph(self, body, pools, shapes)
            self._captures[kind] += 1
            self._capture_s[kind] += time.monotonic() - t0
        return graphs[(kind, bucket)]

    def serving_capture_count(self, kind):
        """Graphs of one ``kind`` captured by this engine so far:
        ``"decode_multi"``, ``"decode_multi_policy"``, ``"verify"``,
        ``"verify_policy"`` or ``"copy_page"``."""
        return self._captures[kind]

    def serving_decode_multi_capture_count(self):
        """Horizon graphs captured by this engine so far, greedy and
        policy summed (the counterpart of the JAX
        ``serving_decode_multi_compile_count``)."""
        return self._captures["decode_multi"] + \
            self._captures["decode_multi_policy"]

    def serving_decode_multi_capture_seconds(self):
        """Wall seconds this engine spent capturing horizon graphs
        (warm-up included)."""
        return self._capture_s["decode_multi"] + \
            self._capture_s["decode_multi_policy"]

    def serving_verify_capture_count(self):
        """Verify graphs captured by this engine so far, greedy and
        policy summed (the counterpart of the JAX
        ``serving_verify_compile_count``): at most one per spec-K bucket
        and path per pool set."""
        return self._captures["verify"] + self._captures["verify_policy"]

    def serving_verify_capture_seconds(self):
        """Wall seconds this engine spent capturing verify graphs
        (warm-up included)."""
        return self._capture_s["verify"] + self._capture_s["verify_policy"]

    def serving_page_copy_capture_count(self):
        """``copy_page`` graphs captured so far (the counterpart of the
        JAX ``serving_page_copy_compile_count``): one per pool set."""
        return self._captures["copy_page"]

    def copy_to_host_async(self, *tensors):
        """Start copying device tensors to the host (pinned buffers,
        non-blocking) and return a :class:`HostCopy`; its ``wait()``
        gives numpy arrays."""
        return HostCopy(tensors)
