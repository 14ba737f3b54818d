"""DeepSpeedEngine: the training engine of the PyTorch port (counterpart
of ``deepspeed_tpu/runtime/engine.py``).  Build it with
:func:`deepspeed_tpu_torch.initialize`.

One device, fp32 master parameters, the compute dtype of the config
(``bf16.enabled`` or ``fp16.enabled``) equal to the model's
``cfg.dtype``: the model casts the masters inside autograd, so gradients
land on them in fp32.  A train step is the JAX engine's math, run
eagerly:

* ``fwd_bwd`` (``engine.py:851``): ``loss * scale / gas`` backward, with
  ``scale`` the fp16 loss scale (``runtime/fp16/loss_scaler.py``; no
  factor at all in bf16 and fp32, where it is 1); over a gas window the
  fp32 gradients sum in ``.grad``;
* ``apply_grads`` (``:880``): divide by ``scale *
  gradient_predivide_factor``, take the global norm, clip by ``min(1,
  clip / (norm + 1e-6))``, then the optimizer at the learning rate of
  the schedule for this step.  In fp16 an overflow (a non-finite
  gradient) keeps the masters, the moments and the optimizer's count as
  they were, bit for bit, and counts a skipped step; the step counter
  and the schedule advance either way, and the scale is updated after.
  The overflow flag, the skip and the scale stay on the device, so a
  step reads nothing back to the host (``train_loop(sync=False)``).

``forward`` / ``backward`` / ``step`` are the per-micro-batch API;
``train_batch`` runs a whole window and ``train_loop`` K windows, the
same math as K ``train_batch`` calls.  ``jit`` and ``lax.scan`` have no
counterpart: PyTorch runs eagerly, so ``train_loop`` is a Python loop
whose losses stay on the device until the caller reads them.

``save_checkpoint`` / ``load_checkpoint`` write and read the JAX
package's checkpoint layout through the config's ``checkpoint_engine``
(``checkpoint/``): the masters under their JAX names, the AdamW state
under the port's own, the counters and the LR schedule in the client
state, so a resumed run equals the uninterrupted one bit for bit.
"""

import os

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint.backend import get_checkpoint_engine
from deepspeed_tpu_torch.checkpoint.engine import _write_npz_streaming
from deepspeed_tpu_torch.checkpoint.params import PARAMS, jax_leaf_names
from deepspeed_tpu_torch.models.gpt2 import (GPT2, gpt2_loss_fn,
                                             init_gpt2_params)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    has_overflow, make_loss_scale_state, update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      get_lr_schedule)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.utils.logging import log_dist, logger

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
# the port's optimizer state in a checkpoint (its own names, beside the
# JAX ones of the masters)
OPT_STATE = ".torch_opt_state"


def _unported(what, item):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               f"package yet: see ROADMAP.md {item}")


class DeepSpeedEngine:
    """Training engine over a native :class:`GPT2`."""

    def __init__(self, model, config, loss_fn=None, lr_scheduler=None,
                 seed=0, device=None):
        if not isinstance(model, GPT2):
            raise _unported(f"training a {type(model).__name__}",
                            "Queue A10 (the other models)")
        self.device = resolve_device(device)
        self._config = DeepSpeedConfig.load(config)
        self.compute_dtype = DTYPES[self._config.precision_dtype]
        if model.cfg.dtype != self.compute_dtype:
            raise ValueError(
                f"the config computes in {self._config.precision_dtype} but "
                f"the model's cfg.dtype is {model.cfg.dtype}: set both "
                "(bf16.enabled / fp16.enabled and GPTConfig(dtype=...)) to "
                "the same type")
        self.module = model.to(device=self.device, dtype=torch.float32)
        self.loss_fn = loss_fn or self._default_loss_fn()
        opt = self._config.optimizer
        self.optimizer_name = opt.type or "adamw"
        self.optimizer, self._base_lr = build_optimizer(
            self.optimizer_name, opt.params, self.module.parameters())
        # fp16: the scaler, the skipped steps and the optimizer's count on
        # the device (the JAX TrainState's scaler / skipped_steps)
        self.fp16_enabled = self._config.fp16.enabled
        self.scaler = make_loss_scale_state(
            self._config.fp16, self.fp16_enabled, self.device)
        self._skipped = torch.zeros((), dtype=torch.int32,
                                    device=self.device)
        if self.fp16_enabled:
            self.optimizer.count = torch.zeros((), dtype=torch.int64,
                                               device=self.device)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.gas = self._config.gradient_accumulation_steps
        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self._pending = None
        self._last_metrics = {}
        self.checkpoint_engine = get_checkpoint_engine(
            self._config.checkpoint_engine.model_dump())
        self._ckpt_writer = None
        self.init_params(seed)

    # ------------------------------------------------------------ config
    def get_global_grad_norm(self):
        norm = self._last_metrics.get("grad_norm")
        return None if norm is None else float(norm)

    @property
    def loss_scale(self):
        """The current loss scale (a host read; 1 outside fp16)."""
        return float(self.scaler.loss_scale)

    @property
    def skipped_steps(self):
        """Optimizer steps skipped on an fp16 overflow (a host read)."""
        return int(self._skipped)

    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_lr()
        return [self._base_lr]

    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            if not isinstance(client_scheduler, LRScheduler) and \
                    callable(client_scheduler) and \
                    not hasattr(client_scheduler, "get_lr"):
                return LRScheduler(client_scheduler)
            return client_scheduler
        s = self._config.scheduler
        if s.type:
            return LRScheduler(get_lr_schedule(s.type, s.params))
        return None

    def _default_loss_fn(self):
        """``module(input_ids)`` -> logits, next-token cross-entropy
        (``engine.py:421`` without the MoE aux term)."""
        def loss_fn(module, batch):
            return gpt2_loss_fn(module(batch["input_ids"]), batch)
        return loss_fn

    # ------------------------------------------------------------ params
    def init_params(self, seed):
        """Fresh fp32 masters drawn from ``seed`` with a ``torch.Generator``
        on the engine's device (the flax initializers of the JAX model)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_gpt2_params(self.module, gen)
        n = sum(p.numel() for p in self.module.parameters())
        log_dist(f"engine initialized: {n / 1e6:.2f}M params, zero_stage="
                 f"{self._config.zero_optimization_stage}, dtype="
                 f"{self._config.precision_dtype}, device={self.device}",
                 ranks=[0])
        return self

    @torch.no_grad()
    def set_params(self, state_dict):
        """Load fp32 masters (tensors or numpy arrays), e.g. weights carried
        from a JAX engine by ``models.gpt2.gpt2_params_from_jax``."""
        state = {k: torch.as_tensor(v).to(self.device, torch.float32)
                 for k, v in state_dict.items()}
        self.module.load_state_dict(state, strict=True)
        return self

    def get_params(self):
        """The fp32 masters, ``{name: tensor}``."""
        return {k: v.detach() for k, v in self.module.state_dict().items()}

    # ------------------------------------------------------------- steps
    def _put_batch(self, batch):
        out = {}
        for key, value in batch.items():
            t = value if isinstance(value, torch.Tensor) else \
                torch.as_tensor(np.asarray(value))
            if not t.is_floating_point():
                t = t.long()
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def forward(self, batch):
        """The loss of one micro batch (the graph is kept for backward)."""
        if self._pending is not None:
            raise RuntimeError("backward() must run between forward() "
                               "calls (for a loss-only pass use eval_batch)")
        self._pending = self.loss_fn(self.module, self._put_batch(batch))
        return self._pending

    def backward(self, loss=None):
        """Accumulate ``loss * scale / gas`` gradients into the fp32
        masters (``scale``: the fp16 loss scale; none in bf16 and fp32)."""
        if self._pending is None:
            raise RuntimeError("backward() must follow forward()")
        loss, self._pending = self._pending, None
        if self.fp16_enabled:
            (loss.float() * self.scaler.loss_scale / self.gas).backward()
        else:
            (loss.float() / self.gas).backward()
        self.micro_steps += 1
        self.global_samples += self._config.train_micro_batch_size_per_gpu
        return loss

    def step(self):
        """At the gradient-accumulation boundary: clip and apply the
        optimizer at this step's learning rate, then advance the
        schedule.  Mid-window it does nothing (returns None)."""
        if self.micro_steps % self.gas != 0:
            return None
        if self._pending is not None:
            raise RuntimeError("step() after forward() without backward()")
        metrics = self._apply_grads(float(self.get_lr()[0]))
        self.global_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self._last_metrics = metrics
        return metrics

    @torch.no_grad()
    def _apply_grads(self, lr):
        params = list(self.module.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        predivide = float(self._config.gradient_predivide_factor or 1.0)
        overflow = None
        if self.fp16_enabled:
            torch._foreach_div_(grads, self.scaler.loss_scale * predivide)
            overflow = has_overflow(grads)
        elif predivide != 1.0:
            torch._foreach_div_(grads, predivide)
        gnorm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        clip = float(self._config.gradient_clipping or 0.0)
        if clip > 0.0:
            torch._foreach_mul_(
                grads, torch.clamp(clip / (gnorm + 1e-6), max=1.0))
        self.optimizer.step(grads, lr, skip=overflow)
        for p in params:
            p.grad = None
        if overflow is None:
            return {"grad_norm": gnorm, "lr": lr}
        self.scaler = update_scale(self.scaler, overflow)
        self._skipped += overflow.to(torch.int32)
        return {"grad_norm": gnorm, "lr": lr, "overflow": overflow,
                "loss_scale": self.scaler.loss_scale}

    def train_batch(self, data_iter=None, batches=None, sync=True):
        """One optimizer step over a window of ``gas`` micro batches;
        returns their mean loss (a float, or a device scalar with
        ``sync=False``)."""
        if batches is None:
            if data_iter is None:
                raise _unported("train_batch without batches or a data "
                                "iterator (a training dataloader)",
                                "Queue A15 (the dataloader)")
            batches = [next(data_iter) for _ in range(self.gas)]
        if len(batches) != self.gas:
            raise ValueError(f"need {self.gas} micro batches, got "
                             f"{len(batches)}")
        losses = []
        for batch in batches:
            losses.append(self.backward(self.forward(batch)).detach())
        metrics = self.step()
        mean = torch.stack(losses).float().mean()
        if self.global_steps % self._config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(mean):.4f} "
                     f"lr={float(metrics['lr']):.3e} grad_norm="
                     f"{float(metrics['grad_norm']):.3f}", ranks=[0])
        return float(mean) if sync else mean

    def train_loop(self, batches, sync=False):
        """``len(batches) // gas`` optimizer steps; returns the window mean
        losses ([K] on the device, or numpy with ``sync=True``)."""
        if len(batches) % self.gas:
            raise ValueError(f"train_loop needs whole windows: "
                             f"{len(batches)} micro batches with gas="
                             f"{self.gas}")
        losses = torch.stack([
            self.train_batch(batches=batches[i:i + self.gas], sync=False)
            for i in range(0, len(batches), self.gas)])
        return losses.cpu().numpy() if sync else losses

    @torch.no_grad()
    def eval_batch(self, batch):
        """Loss-only forward (a device scalar)."""
        return self.loss_fn(self.module, self._put_batch(batch))

    # -------------------------------------------------------- checkpoint
    def _checkpoint_leaves(self, optimizer=True, scaler=True):
        """``(state, transposed)``: the checkpoint's leaves by name — the
        fp32 masters under their JAX names (``checkpoint/params.py``),
        ``.step``, with ``scaler`` the JAX TrainState's ``.skipped_steps``
        and ``.scaler.loss_scale`` / ``.good_steps`` / ``.hysteresis``
        (the unit scaler outside fp16, as the JAX engine writes it), and
        with ``optimizer`` the AdamW moments and count under
        ``.torch_opt_state`` by ``state_dict`` name — and the names of the
        2-D masters written as ``[in, out]`` kernels."""
        names = jax_leaf_names(self.module)
        params = dict(self.module.named_parameters())
        state, transposed = {}, set()
        # the JAX tree's order: keys sorted at each level
        for name, (leaf, tr) in sorted(names.items(), key=lambda kv: kv[1]):
            state[PARAMS + leaf] = params[name]
            if tr:
                transposed.add(PARAMS + leaf)
        state[".step"] = np.int32(self.global_steps)
        if scaler:
            state[".skipped_steps"] = self._skipped
            for key in ("loss_scale", "good_steps", "hysteresis"):
                state[f".scaler.{key}"] = getattr(self.scaler, key)
        if optimizer:
            for key, moments in (("mu", self.optimizer.mu),
                                 ("nu", self.optimizer.nu)):
                for name, m in zip(params, moments):
                    state[f"{OPT_STATE}[{key!r}][{name!r}]"] = m
            count = self.optimizer.count
            state[f"{OPT_STATE}['count']"] = count if \
                isinstance(count, torch.Tensor) else np.int64(count)
        return state, transposed

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, async_save=None):
        """``<save_dir>/<tag>/`` in the JAX layout (``checkpoint/engine.py``)
        and the ``latest`` file (the JAX ``save_checkpoint``,
        ``runtime/engine.py:2260-2331``).  The state is copied to host
        memory before this returns, so the next step cannot change what is
        written; with ``async_save`` (default: the config's
        ``checkpoint.async_save``) the write runs on a thread —
        :meth:`wait_checkpoint` joins it.  ``client_state`` (JSON) comes
        back from :meth:`load_checkpoint`."""
        if async_save is None:
            async_save = self._config.checkpoint.async_save
        tag = tag or f"global_step{self.global_steps}"
        path = os.path.join(save_dir, str(tag))
        client = dict(client_state or {})
        client.update({
            "global_steps": self.global_steps,
            "micro_steps": self.micro_steps,
            "global_samples": self.global_samples,
            "lr_scheduler": self.lr_scheduler.state_dict()
            if isinstance(self.lr_scheduler, LRScheduler) else None})
        self.wait_checkpoint()
        state, transposed = self._checkpoint_leaves()

        def finalize():
            if self._config.zero_optimization \
                    .gather_16bit_weights_on_model_save:
                self.checkpoint_engine.consolidate_16bit(
                    path, "weights_16bit.npz", dtype=np.float16)
            if save_latest:
                with open(os.path.join(save_dir, "latest"), "w") as f:
                    f.write(str(tag))
            self.checkpoint_engine.commit(tag)

        self.checkpoint_engine.create(tag)
        self._ckpt_writer = self.checkpoint_engine.save(
            path, state, client, async_write=async_save, on_done=finalize,
            transposed=transposed)
        log_dist(f"saved checkpoint {path}", ranks=[0])
        return path

    def wait_checkpoint(self):
        """Join any in-flight async checkpoint write."""
        writer, self._ckpt_writer = self._ckpt_writer, None
        if writer is not None:
            writer.wait()

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore a checkpoint of :meth:`save_checkpoint` (the JAX
        ``load_checkpoint``, ``:2340-2410``): the fp32 masters, and the
        optimizer state, the step counters and the LR schedule.  ``tag``
        defaults to ``latest`` (none there: nothing is loaded and ``(None,
        {})`` returns).  A JAX-written checkpoint has the masters but not
        the port's optimizer state: load it with
        ``load_optimizer_states=False``.  An fp16 engine also restores the
        loss scaler and the skipped steps (the JAX TrainState's names, so
        a JAX fp16 checkpoint gives its scaler too); bf16 and fp32 engines
        keep the unit scaler.  Returns ``(path, client_state)``."""
        self.wait_checkpoint()
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.exists(latest):
                logger.warning(f"no 'latest' file in {load_dir}; nothing "
                               "loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        path = os.path.join(load_dir, str(tag))
        state, transposed = self._checkpoint_leaves(
            load_optimizer_states, scaler=self.fp16_enabled)
        state.pop(".step")
        target = {name: tuple(t.shape)[::-1] if name in transposed
                  else tuple(np.shape(t)) for name, t in state.items()}
        try:
            loaded, client = self.checkpoint_engine.load(path, target)
        except KeyError as e:
            if load_optimizer_states and OPT_STATE in str(e):
                raise KeyError(f"{e.args[0]}: the checkpoint holds no port "
                               "optimizer state (a JAX-written one?); load "
                               "it with load_optimizer_states=False") from e
            raise
        for name, dst in state.items():
            src = loaded.pop(name)
            if isinstance(dst, torch.Tensor):
                # scalars are stored as (1,)
                dst.copy_(src.t() if name in transposed
                          else src.reshape(dst.shape))
            else:
                self.optimizer.count = int(src)
        self.global_steps = client.get("global_steps", 0)
        self.micro_steps = client.get("micro_steps", 0)
        self.global_samples = client.get("global_samples", 0)
        if load_lr_scheduler_states and client.get("lr_scheduler") and \
                isinstance(self.lr_scheduler, LRScheduler):
            self.lr_scheduler.load_state_dict(client["lr_scheduler"])
        log_dist(f"loaded checkpoint {path}", ranks=[0])
        return path, client

    def save_16bit_model(self, save_dir, save_filename="weights_16bit.npz"):
        """The fp32 masters as float16 under their JAX names in one
        ``.npz``: the file ``consolidate(tag_dir, out, dtype=np.float16)``
        writes from a checkpoint of this step (and the one
        ``gather_16bit_weights_on_model_save`` leaves beside each save).
        Returns its path."""
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, save_filename)
        state, transposed = self._checkpoint_leaves(optimizer=False,
                                                    scaler=False)
        state.pop(".step")

        def leaves():
            for name, t in state.items():
                a = t.detach().to("cpu", torch.float32).numpy()
                yield name, (a.T if name in transposed else a).astype(
                    np.float16)
        _write_npz_streaming(out, leaves())
        return out
