"""Loss scaling for fp16 training (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The scaler state is a few 0-d tensors on the engine's device, so the
overflow check, the skip-step decision and the scale update of a train
step stay on the device with no host read, as the JAX engine keeps them
inside its jitted step.  :func:`update_scale` is the JAX function's
arithmetic (``:63-90``) on torch tensors: on an overflow the hysteresis
counts down and, once exhausted, the scale halves (not below
``min_scale``) and the hysteresis refills; after ``scale_window``
consecutive good steps the scale doubles.  With
``consecutive_hysteresis`` the hysteresis refills on every good step,
otherwise only when the scale grows (the reference default).
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    loss_scale: torch.Tensor       # f32 scalar
    good_steps: torch.Tensor       # i32 scalar: consecutive non-overflow steps
    hysteresis: torch.Tensor       # i32 scalar: remaining tolerated overflows
    # static config
    scale_window: int = 1000
    min_scale: float = 1.0
    scale_factor: float = 2.0
    init_hysteresis: int = 2
    dynamic: bool = True
    consecutive_hysteresis: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _state(scale, hysteresis, device, **static):
    return LossScaleState(
        loss_scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32, device=device),
        **static)


def make_loss_scale_state(fp16_config=None, enabled=True, device="cpu"):
    """Scaler state from an ``Fp16Config``; disabled (bf16, fp32) -> the
    unit scale, static, with hysteresis 1 (what a JAX checkpoint holds
    there)."""
    if fp16_config is None or not enabled:
        return _state(1.0, 1, device, dynamic=False)
    return _state(
        fp16_config.initial_dynamic_scale, fp16_config.hysteresis, device,
        scale_window=fp16_config.loss_scale_window,
        min_scale=fp16_config.min_loss_scale,
        init_hysteresis=fp16_config.hysteresis,
        dynamic=fp16_config.dynamic_loss_scale,
        consecutive_hysteresis=fp16_config.consecutive_hysteresis)


def has_overflow(grads):
    """A bool scalar tensor: True if any entry of ``grads`` (a list of
    tensors) is non-finite (the reference ``CheckOverflow``)."""
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    finite = torch.stack([torch.isfinite(g).all() for g in grads])
    return ~finite.all()


def update_scale(state, overflow):
    """One reference ``update_scale`` step on the device; ``overflow`` is
    a bool scalar tensor."""
    if not state.dynamic:
        return state
    i32 = torch.int32
    # overflow path
    hysteresis_left = state.hysteresis - 1
    exhausted = hysteresis_left <= 0
    dec_scale = torch.clamp(state.loss_scale / state.scale_factor,
                            min=state.min_scale)
    new_scale_ovf = torch.where(exhausted, dec_scale, state.loss_scale)
    init_h = torch.full_like(state.hysteresis, state.init_hysteresis)
    new_hyst_ovf = torch.where(exhausted, init_h, hysteresis_left)
    # success path
    grown = (state.good_steps + 1) % state.scale_window == 0
    new_scale_ok = torch.where(grown, state.loss_scale * state.scale_factor,
                               state.loss_scale)
    new_good_ok = torch.where(grown, torch.zeros_like(state.good_steps),
                              state.good_steps + 1)
    if state.consecutive_hysteresis:
        new_hyst_ok = init_h
    else:
        new_hyst_ok = torch.where(grown, init_h, state.hysteresis)
    return state.replace(
        loss_scale=torch.where(overflow, new_scale_ovf, new_scale_ok),
        good_steps=torch.where(overflow, torch.zeros_like(state.good_steps),
                               new_good_ok).to(i32),
        hysteresis=torch.where(overflow, new_hyst_ovf,
                               new_hyst_ok).to(i32))


class DynamicLossScaler:
    """Host-side wrapper keeping the reference class surface."""

    def __init__(self, init_scale=2**16, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=2, consecutive_hysteresis=False,
                 device="cpu"):
        self.state = _state(
            init_scale, delayed_shift, device, scale_window=scale_window,
            min_scale=min_scale, scale_factor=scale_factor,
            init_hysteresis=delayed_shift,
            consecutive_hysteresis=consecutive_hysteresis)

    @property
    def loss_scale(self):
        return float(self.state.loss_scale)

    def update_scale(self, overflow):
        self.state = update_scale(
            self.state, torch.as_tensor(bool(overflow),
                                        device=self.state.loss_scale.device))

    def backward(self, loss):
        return loss * self.state.loss_scale


class LossScaler(DynamicLossScaler):
    """Static loss scaler (reference ``LossScaler``)."""

    def __init__(self, scale=1.0, device="cpu"):
        super().__init__(init_scale=scale, device=device)
        self.state = self.state.replace(dynamic=False)
