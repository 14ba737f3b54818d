"""Learning-rate schedules (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py``, copied: host arithmetic).

Reference: ``deepspeed/runtime/lr_schedules.py`` — ``LRRangeTest`` (:258),
``OneCycle`` (:361), ``WarmupLR`` (:626), ``WarmupDecayLR``.  Each
schedule is a pure ``step -> lr`` function; the engine reads it on the
host and hands the value to the optimizer per step.  ``LRScheduler``
keeps the reference's ``step()/get_lr()/state_dict()/load_state_dict()``
surface.
"""


import math

VALID_LR_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR",
                     "WarmupCosineLR"]


def warmup_lr(warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000,
              warmup_type="log"):
    """WarmupLR: ramp from min to max then hold (reference :626)."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        if step >= warmup_num_steps:
            return warmup_max_lr
        if warmup_type == "log":
            gamma = math.log(step + 1) / math.log(warmup_num_steps)
        else:
            gamma = (step + 1) / warmup_num_steps
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * min(1.0, gamma)

    return schedule


def warmup_decay_lr(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                    warmup_num_steps=1000, warmup_type="log"):
    """WarmupDecayLR: warmup then linear decay to zero."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        if step < warmup_num_steps:
            return base(step)
        frac = (total_num_steps - step) / max(1, total_num_steps - warmup_num_steps)
        return warmup_max_lr * max(0.0, frac)

    return schedule


def warmup_cosine_lr(total_num_steps, warmup_min_ratio=0.0, warmup_num_steps=1000,
                     cos_min_ratio=0.0001, warmup_max_lr=0.001):
    def schedule(step):
        if step < warmup_num_steps:
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * (step / max(1, warmup_num_steps))
            return warmup_max_lr * ratio
        progress = (step - warmup_num_steps) / max(1, total_num_steps - warmup_num_steps)
        progress = min(1.0, progress)
        cos = 0.5 * (1 + math.cos(math.pi * progress))
        return warmup_max_lr * (cos_min_ratio + (1 - cos_min_ratio) * cos)

    return schedule


def lr_range_test(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                  lr_range_test_step_rate=1.0, lr_range_test_staircase=False):
    """LRRangeTest (reference :258): lr grows (continuously or staircase)."""

    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1 + interval * lr_range_test_step_rate)

    return schedule


def one_cycle(cycle_min_lr, cycle_max_lr, cycle_first_step_size=2000,
              cycle_second_step_size=None, cycle_first_stair_count=0,
              cycle_second_stair_count=None, decay_step_size=0,
              decay_lr_rate=0.0, **_unused):
    """OneCycle (reference :361); the optimizer betas stay static (the
    momentum cycle is not modelled, as in the JAX package)."""
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size

    def schedule(step):
        if step <= cycle_first_step_size:
            frac = step / cycle_first_step_size
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        cycle_end = cycle_first_step_size + second
        if step <= cycle_end:
            frac = (step - cycle_first_step_size) / second
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac
        # decay phase
        if decay_step_size > 0:
            decay_intervals = (step - cycle_end) / decay_step_size
            return max(0.0, cycle_min_lr * (1 - decay_lr_rate) ** decay_intervals)
        return cycle_min_lr

    return schedule


SCHEDULE_BUILDERS = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "LRRangeTest": lr_range_test,
    "OneCycle": one_cycle,
}


def get_lr_schedule(name, params):
    if name not in SCHEDULE_BUILDERS:
        raise ValueError(f"Unknown LR schedule {name}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_BUILDERS[name](**params)


class LRScheduler:
    """Stateful wrapper with the torch-style interface the reference exposes."""

    def __init__(self, schedule_fn):
        self.schedule_fn = schedule_fn
        self.last_step = 0

    def step(self, increment=1):
        self.last_step += increment

    def get_lr(self):
        return [self.schedule_fn(self.last_step)]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]
