"""Optimizer factory (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

Config ``optimizer.type`` -> an optimizer over the fp32 master
parameters.  Every Adam spelling (``Adam``, ``AdamW``, ``FusedAdam``,
``CPUAdam``, ``DeepSpeedCPUAdam``) is the update of ``optax.adam`` /
``optax.adamw``, as the JAX package builds it (``build_optimizer``,
``optimizers.py:25``); the other optimizer names raise
``NotImplementedError`` naming ROADMAP.md Queue A18.  The learning rate
is handed to each :meth:`Adam.step`, which is what
``optax.inject_hyperparams`` does for the JAX engine (``:94``).
"""

import torch

ADAM_NAMES = ("adam", "adamw", "fusedadam", "cpuadam", "deepspeedcpuadam")
UNPORTED_NAMES = ("lamb", "fusedlamb", "sgd", "adagrad", "lion",
                  "onebitadam", "onebitlamb", "zerooneadam")
PARAM_KEYS = ("lr", "betas", "eps", "weight_decay", "adam_w_mode")


class Adam:
    """optax's Adam update on a list of fp32 tensors, in place:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``u = m_hat /
    (sqrt(v_hat) + eps)`` with bias-corrected moments, plus ``weight_decay
    * p`` on every parameter when ``weight_decay`` is set (decoupled, as
    ``optax.adamw`` applies it at ``:77-81``), then ``p -= lr * u``."""

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        self.params = list(params)
        self.betas = tuple(float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads, lr):
        """One update with ``grads`` (one per parameter) at ``lr``."""
        b1, b2 = self.betas
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        u = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, u, alpha=-float(lr))


def build_optimizer(name, params, parameters):
    """(optimizer, static lr) from a config ``optimizer`` section.  An
    Adam spelling other than ``AdamW`` with ``adam_w_mode: false`` is
    ``optax.adam`` (no weight decay); otherwise it is ``optax.adamw``."""
    params = dict(params or {})
    name = (name or "adamw").lower()
    if name in UNPORTED_NAMES:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to the PyTorch package yet: "
            "see ROADMAP.md Queue A18 (the other optimizers)")
    if name not in ADAM_NAMES:
        raise ValueError(f"Unknown optimizer type: {name}")
    unknown = sorted(set(params) - set(PARAM_KEYS))
    if unknown:
        raise ValueError(f"optimizer params {unknown} are not taken (the "
                         f"port's Adam takes {PARAM_KEYS})")
    lr = float(params.get("lr", 1e-3))
    decay = float(params.get("weight_decay", 0.0))
    if name != "adamw" and not params.get("adam_w_mode", True):
        decay = 0.0
    return Adam(parameters, betas=params.get("betas", (0.9, 0.999)),
                eps=params.get("eps", 1e-8), weight_decay=decay), lr
