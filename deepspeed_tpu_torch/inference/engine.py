"""InferenceEngine: the serving wrapper of the PyTorch port (counterpart
of ``deepspeed_tpu/inference/engine.py``).

What carries over: ``init_params`` / ``set_params``, ``generate`` over a
dense KV cache bucketed to 128 positions, the greedy contract of
``sample_from_logits``, and the slot primitives the paged scheduler
drives — ``init_paged_cache``, ``prefill_into_slots``, ``decode_step``
and ``decode_multi``.  ``jit`` has no counterpart: PyTorch runs eagerly,
so ``decode_multi``'s ``lax.scan`` is a Python loop over the horizon
whose carries (token, active mask, lengths, emitted count) stay on the
device; the host syncs once per horizon, when the scheduler pulls the
token block.  CUDA graphs for the horizon are ROADMAP.md Queue A5.

Sampled decoding (``do_sample=True`` with a temperature) is ROADMAP.md
Queue A6 and raises; greedy is an fp32 argmax whose ties go to the
lowest token id (``torch.argmax`` returns the first maximal index).
"""

import dataclasses

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.ops.attention.decode import paged_kernel_decision
from deepspeed_tpu_torch.utils.logging import log_dist

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def check_greedy(do_sample, temperature):
    """Raise for sampled decoding, which is not ported yet."""
    if do_sample and temperature:
        raise NotImplementedError(
            "sampled decoding is not ported to the PyTorch package yet: "
            "see ROADMAP.md Queue A6 (sampling and grammar policies)")


def _sample_tokens(logits, do_sample=False, temperature=1.0):
    """Next token from [batch, vocab] logits under THE greedy contract:
    an argmax over the fp32 logits, ties to the lowest token id."""
    check_greedy(do_sample, temperature)
    return torch.argmax(logits.float(), dim=-1)


class InferenceEngine:
    """Wraps a ``Llama`` module for generation and paged serving."""

    def __init__(self, model, config, params=None, seed=0):
        if not isinstance(model, llama.Llama):
            raise NotImplementedError(
                f"the PyTorch package serves a native Llama only, got "
                f"{type(model).__name__}: see ROADMAP.md Queue A7 (GPT-2) "
                "and A8 (HF ingestion)")
        self._config = config
        self.device = resolve_device(config.device)
        if config.paged_kernel == "force" and self.device.type != "cuda":
            raise ValueError("paged_kernel='force' needs the kernels, which "
                             "run only on a CUDA device")
        self.dtype = DTYPES[config.dtype]
        self.kv_dtype = DTYPES[config.kv_cache_dtype]
        self.seed = int(seed)
        if config.replace_with_kernel_inject and \
                model.cfg.attn_impl != "auto":
            # a fresh module (never the caller's, which may be live
            # elsewhere) with the caller's weights and attn_impl "auto"
            fresh = type(model)(dataclasses.replace(model.cfg,
                                                    attn_impl="auto"),
                                device="meta").to_empty(device=self.device)
            fresh.load_state_dict(model.state_dict())
            model = fresh
        self.module = model.to(device=self.device, dtype=self.dtype).eval()
        self.module.requires_grad_(False)
        if params is not None:
            self.set_params(params)

    # ------------------------------------------------------------ params
    @torch.no_grad()
    def init_params(self, seed=None):
        """Random weights from a seeded ``torch.Generator`` on the engine's
        device: normal(0, 0.02) projections and embeddings, ones for the
        norms — the flax initializers of the JAX model."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed if seed is None else int(seed))
        for name, p in self.module.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        self._log_params()
        return self

    @torch.no_grad()
    def set_params(self, state_dict):
        """Load a ``state_dict`` (tensors or numpy arrays), cast to the
        engine's dtype and placed on its device."""
        state = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        self.module.load_state_dict(state, strict=True)
        self._log_params()
        return self

    def _log_params(self):
        n = sum(p.numel() for p in self.module.parameters())
        log_dist(f"inference params ready: {n / 1e6:.1f}M, dtype="
                 f"{self._config.dtype}, device={self.device}", ranks=[0])

    # ----------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, input_ids):
        """Full causal forward -> logits [b, l, vocab] (no cache)."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
        return self.module(ids.long())

    __call__ = forward

    # ---------------------------------------------------------- generate
    def sample_from_logits(self, logits, do_sample=False, temperature=1.0):
        """Greedy next token(s): a [vocab] row returns an int, a list of
        rows or an [n, vocab] batch returns a list (one device call)."""
        if isinstance(logits, (list, tuple)):
            rows = torch.stack([torch.as_tensor(r) for r in logits])
        else:
            rows = torch.as_tensor(logits)
        single = rows.ndim == 1
        toks = _sample_tokens(rows[None] if single else rows, do_sample,
                              temperature).tolist()
        return toks[0] if single else toks

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, eos_token_id=None):
        """Greedy generation over a dense KV cache.  Returns the prompt
        followed by the new tokens, as a numpy array [b, len]; rows that
        emitted ``eos_token_id`` continue with it as fill.  The cache
        length rounds up to 128 positions (``engine.py:1855-1862``); the
        tokens are those of the JAX package's bucketed scan, which only
        runs extra steps past the returned ones."""
        check_greedy(do_sample, temperature)
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
        bucket = 128
        cache_len = min(-(-max_len // bucket) * bucket,
                        self._config.max_out_tokens)
        cache = llama.init_kv_cache(self.module.cfg, b, max_len=cache_len,
                                    dtype=self.kv_dtype, device=self.device)
        logits, cache = self.module(
            torch.as_tensor(ids, device=self.device).long(), cache=cache)
        tok = _sample_tokens(logits[:, -1])
        toks = [tok]
        finished = torch.zeros(b, dtype=torch.bool, device=self.device)
        if eos_token_id is not None:
            finished |= tok == eos_token_id
        for _ in range(max_new_tokens - 1):
            logits, cache = self.module(tok[:, None], cache=cache)
            nxt = _sample_tokens(logits[:, 0])
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
                finished |= nxt == eos_token_id
            tok = nxt
            toks.append(tok)
        gen = torch.stack(toks, dim=1).cpu().numpy().astype(ids.dtype)
        return np.concatenate([ids, gen], axis=1)

    # ------------------------------------------------------ paged serving
    def paged_kernel_decision(self):
        """The paged-attention dispatch decision for this engine's device
        and model (``ops/attention/decode.paged_kernel_decision``)."""
        cfg = self.module.cfg
        return paged_kernel_decision(
            device_type=self.device.type, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            dtype=self.kv_dtype)

    def init_paged_cache(self, num_pages, page_size, kv_dtype=None):
        """Per-layer K/V page pools on the engine's device (each holds
        ``num_pages`` pages plus the drop sink, ``ops/quant/kv.py``)."""
        if kv_dtype is not None:
            raise NotImplementedError(
                "a per-pool kv_dtype is not ported to the PyTorch package "
                "yet: see ROADMAP.md Queue A1 (quantized paged KV)")
        dec = self.paged_kernel_decision()
        if dec["path"] == "unsupported":
            raise ValueError(dec["reason"])
        log_dist(f"paged attention path: {dec['path']} — {dec['reason']}",
                 ranks=[0])
        return llama.init_paged_kv_cache(self.module.cfg, num_pages,
                                         page_size, dtype=self.kv_dtype,
                                         device=self.device)

    def _stage(self, x, dtype):
        """Host array (or a carry already on the device) -> device tensor."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

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
                    do_sample=False, temperature=1.0):
        """One decode step over ALL slots: write each active slot's token
        K/V at position lengths[slot], attend through the page table and
        return (next tokens [slots] int32 on the device, pools)."""
        cache = dict(pools, page_table=self._stage(page_table, torch.int32),
                     lengths=self._stage(lengths, torch.int32),
                     active=self._stage(active, torch.bool))
        logits, _ = self.module(self._stage(toks, torch.long)[:, None],
                                cache=cache)
        return _sample_tokens(logits[:, 0], do_sample,
                              temperature).to(torch.int32), pools

    @torch.no_grad()
    def decode_multi(self, toks, active, page_table, lengths, pools, *,
                     horizon, budgets, eos_ids, emitted=None,
                     do_sample=False, temperature=1.0):
        """``horizon`` decode steps over all slots with the feedback on the
        device.  Returns ``(toks_block [slots, H], valid [slots, H],
        tok_end, active_end, lengths_end, emitted_end, pools)``, all
        device tensors.  A slot freezes after sampling ``eos_ids[slot]``
        (-1 = none) or once its ``emitted`` count reaches
        ``budgets[slot]``; frozen slots write no K/V (the sink takes their
        rows), advance no length and emit ``valid=False`` rows — the JAX
        ``decode_multi`` rules (``engine.py:829-873``)."""
        check_greedy(do_sample, temperature)
        tok = self._stage(toks, torch.int32)
        active = self._stage(active, torch.bool)
        lengths = self._stage(lengths, torch.int32)
        budgets = self._stage(budgets, torch.int32)
        eos_ids = self._stage(eos_ids, torch.int32)
        emitted = torch.zeros_like(budgets) if emitted is None \
            else self._stage(emitted, torch.int32)
        page_table = self._stage(page_table, torch.int32)
        out_toks, out_valid = [], []
        for _ in range(int(horizon)):
            cache = dict(pools, page_table=page_table, lengths=lengths,
                         active=active)
            logits, cache = self.module(tok.long()[:, None], cache=cache)
            nxt = _sample_tokens(logits[:, 0]).to(torch.int32)
            nxt = torch.where(active, nxt, tok)
            emitted = emitted + active.to(torch.int32)
            out_toks.append(nxt)
            out_valid.append(active)
            lengths = cache["lengths"]
            active = active & (nxt != eos_ids) & (emitted < budgets)
            tok = nxt
        return (torch.stack(out_toks, 1), torch.stack(out_valid, 1), tok,
                active, lengths, emitted, pools)
