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
    def step(self, grads, lr, skip=None):
        """One update with ``grads`` (one per parameter) at ``lr``.  With
        ``skip`` (a bool scalar tensor: the fp16 overflow flag) the update
        is taken on copies, and each state tensor takes ``where(skip, old,
        new)`` (the JAX engine's skip, ``runtime/engine.py:903-910``): the
        parameters, the moments and the count (then a device tensor) stay
        as they were, bit for bit, where it is True, and nothing is read
        back to the host."""
        b1, b2 = self.betas
        if skip is None:
            self.count += 1
            self._update(self.mu, self.nu, self.params, grads, lr,
                         1.0 - b1 ** self.count, 1.0 - b2 ** self.count)
            return
        count = self.count + 1
        c = count.double()
        new = [[t.clone() for t in ts] for ts in (self.mu, self.nu,
                                                   self.params)]
        self._update(*new, grads, lr, (1.0 - torch.pow(b1, c)).float(),
                     (1.0 - torch.pow(b2, c)).float())
        for olds, news in zip((self.mu, self.nu, self.params), new):
            for old, n in zip(olds, news):
                torch.where(skip, old, n, out=old)
        self.count = torch.where(skip, self.count, count)

    def _update(self, mu, nu, params, grads, lr, bc1, bc2):
        """The update in place on ``mu``, ``nu`` and ``params``, with the
        bias corrections ``bc1`` / ``bc2`` (host floats or 0-d tensors)."""
        b1, b2 = self.betas
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, params, alpha=self.weight_decay)
        torch._foreach_add_(params, u, alpha=-float(lr))


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
