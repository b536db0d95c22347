"""Optimizer and learning-rate schedules (counterpart of
``geossl_tpu/train/optim.py``; reference ``pretrain_GeoSSL.py:343-351``,
``finetune_qm9.py:503-523``).

``make_optimizer`` returns ``torch.optim.Adam`` with torch's L2 weight decay
(added to the gradient, as ``optax.add_decayed_weights`` before Adam) and a
``LambdaLR`` stepped once per optimizer step, whose lr at step g equals the
JAX package's optax schedule at count g:

* ``CosineAnnealingLR``: per-epoch cosine (constant within an epoch);
* ``CosineAnnealingWarmRestarts``: per-step cosine with eta_min=1e-4, step g
  at fractional epoch (g-1)/steps_per_epoch (the reference's post-step call);
* ``StepLR``; ``None`` and ``ReduceLROnPlateau`` constant, the latter scaled
  by a :class:`PlateauController` between epochs (:func:`set_plateau_scale`).

Per-group lr factors, the counterpart of the JAX package's
``scale_by_group`` (RR's AutoEncoders): :func:`param_groups` gives each named
module a torch parameter group at ``lr · factor``; the ``LambdaLR``
multiplies every group by the same schedule factor, which is exact for the
multiplicative schedules and is refused, as in the JAX package, under
``CosineAnnealingWarmRestarts`` and ``ReduceLROnPlateau`` (their floors are
anchored per group).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

SCHEDULERS = ("CosineAnnealingLR", "CosineAnnealingWarmRestarts", "StepLR",
              "ReduceLROnPlateau", "None")


def lr_schedule(scheduler: str, lr: float, epochs: int, steps_per_epoch: int,
                min_lr: float = 0.0, decay_factor: float = 0.5,
                decay_step_size: int = 100):
    """step -> lr, the optax schedule of the JAX package's ``make_optimizer``."""
    spe = max(steps_per_epoch, 1)
    if scheduler == "CosineAnnealingLR":
        def sched(step):
            epoch = min(step // spe, epochs)
            return min_lr + (lr - min_lr) * 0.5 * (
                1.0 + math.cos(math.pi * epoch / epochs))
    elif scheduler == "CosineAnnealingWarmRestarts":
        eta_min = 1e-4  # the reference hardcodes it (finetune_qm9.py:509-511)

        def sched(step):
            t = max(step - 1, 0) / spe
            return eta_min + (lr - eta_min) * 0.5 * (
                1.0 + math.cos(math.pi * math.fmod(t, epochs) / epochs))
    elif scheduler == "StepLR":
        def sched(step):
            return lr * decay_factor ** ((step // spe) // decay_step_size)
    elif scheduler in ("ReduceLROnPlateau", "None"):
        def sched(step):
            return lr
    else:
        raise ValueError(f"unknown lr_scheduler {scheduler!r}; one of "
                         f"{SCHEDULERS}")
    return sched


class _Schedule:
    """LambdaLR's multiplier: schedule(step) / lr times the plateau scale."""

    def __init__(self, sched, lr: float):
        self.sched = sched
        self.lr = lr
        self.scale = 1.0

    def __call__(self, step: int) -> float:
        return self.sched(step) / self.lr * self.scale


def param_groups(modules: dict, lr: float,
                 factors: Optional[dict] = None) -> list:
    """One torch parameter group per entry of ``modules`` (name -> module),
    group ``name`` at ``lr · factors[name]`` (default 1): the JAX package's
    ``scale_by_group`` on its top-level parameter names."""
    factors = factors or {}
    return [{"params": list(m.parameters()), "lr": lr * factors.get(k, 1.0)}
            for k, m in modules.items()]


def make_optimizer(params, lr: float, epochs: int, steps_per_epoch: int,
                   weight_decay: float = 0.0,
                   scheduler: str = "CosineAnnealingLR", min_lr: float = 0.0,
                   decay_factor: float = 0.5, decay_step_size: int = 100):
    """(Adam, LambdaLR); call ``sched.step()`` after every ``opt.step()``.
    ``params``: parameters, or parameter groups (:func:`param_groups`)
    whose ``lr`` each schedule multiplies."""
    params = list(params)
    if any(isinstance(g, dict) and g.get("lr", lr) != lr for g in params) \
            and scheduler in ("CosineAnnealingWarmRestarts",
                              "ReduceLROnPlateau"):
        # torch anchors these schedules' floors (eta_min / min_lr) per group
        # base lr; one multiplier for every group cannot reproduce that
        raise ValueError(
            f"per-group lr factors are not torch-exact under {scheduler} "
            "(anchored eta_min/min_lr floors); use CosineAnnealingLR, "
            "StepLR, or None")
    factor = _Schedule(lr_schedule(scheduler, lr, epochs, steps_per_epoch,
                                   min_lr, decay_factor, decay_step_size), lr)
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def _set_lr(group: dict, lr: float) -> None:
    """Write a group's lr; in place where it is a device tensor (a CUDA
    graph reads it at that address)."""
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(lr)
    else:
        group["lr"] = lr


def set_plateau_scale(sched: torch.optim.lr_scheduler.LambdaLR,
                      scale: float) -> None:
    """Run from the next optimizer step on at ``lr · scale`` (the JAX
    package's ``scale_by_plateau`` stage)."""
    for factor, group in zip(sched.lr_lambdas, sched.optimizer.param_groups):
        factor.scale = scale
        _set_lr(group, group["initial_lr"] * factor(sched.last_epoch))


# -- several steps per call (--steps_per_call, train/common.ChainStep) --------


def scheduled_lrs(sched: torch.optim.lr_scheduler.LambdaLR,
                  count: int) -> list:
    """[count][groups]: each group's lr at the next ``count`` optimizer
    steps, the lrs that ``count`` eager steps, each followed by
    ``sched.step()``, would run at (the plateau scale included)."""
    t = sched.last_epoch
    return [[base * lam(t + i) for base, lam in zip(sched.base_lrs,
                                                    sched.lr_lambdas)]
            for i in range(count)]


def advance(sched: torch.optim.lr_scheduler.LambdaLR, count: int) -> None:
    """``count`` calls of ``sched.step()`` in one: the step count moves on
    and each group's lr becomes the next step's."""
    sched.last_epoch += count
    for base, lam, group in zip(sched.base_lrs, sched.lr_lambdas,
                                sched.optimizer.param_groups):
        _set_lr(group, base * lam(sched.last_epoch))


def _scalar_dtype() -> torch.dtype:
    # the dtype Adam keeps its step count in
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def make_capturable(opt: torch.optim.Adam) -> None:
    """Ready Adam for CUDA graph capture: ``capturable`` on, the fused
    implementation (one kernel for all parameters where the foreach path
    launches several: 0.13-0.45 ms less device time per step at bucket 32,
    PERF.md §6, PR 16), each group's lr a device tensor (a graph reads it
    there, where a Python float would be baked in), and the state made now
    (a capture must not make it: its zeros would be replayed)."""
    for group in opt.param_groups:
        group["capturable"] = True
        group["foreach"], group["fused"] = False, True
        params = group["params"]
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = torch.tensor(float(group["lr"]),
                                       dtype=torch.float32,
                                       device=params[0].device)
        for p in params:
            state = opt.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=_scalar_dtype(),
                                            device=p.device)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                if group["amsgrad"]:
                    state["max_exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            else:
                state["step"] = state["step"].to(p.device)


def portable_state_dict(opt: torch.optim.Adam) -> dict:
    """``opt.state_dict()`` in the eager form (lr a float, ``capturable``
    and ``fused`` off, each step count on the CPU), which a run with or
    without CUDA graphs loads alike."""
    sd = opt.state_dict()
    groups = [{**g, "lr": float(g["lr"]), "capturable": False,
               "fused": None, "foreach": None}
              for g in sd["param_groups"]]
    state = {k: ({**v, "step": v["step"].detach().cpu()} if "step" in v
                 else v) for k, v in sd["state"].items()}
    return {"state": state, "param_groups": groups}


class PlateauController:
    """``ReduceLROnPlateau`` on the host (mode='min', threshold=1e-4 rel,
    cooldown=0, torch's defaults); ``step(loss)`` returns the lr multiplier.
    ``state()``/``load()`` round-trip through the resume checkpoint."""

    def __init__(self, base_lr: float, factor: float = 0.5,
                 patience: int = 50, min_lr: float = 1e-6,
                 threshold: float = 1e-4):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"plateau factor must be in (0,1), got {factor}")
        self.base_lr = float(base_lr)
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_lr = float(min_lr)
        self.threshold = float(threshold)
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, loss: float) -> float:
        loss = float(loss)
        if loss < self.best * (1.0 - self.threshold):
            self.best = loss
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            old_lr = self.base_lr * self.scale
            new_lr = max(old_lr * self.factor, self.min_lr)
            if old_lr - new_lr > 1e-8:  # torch's eps gate
                self.scale = new_lr / self.base_lr
            self.num_bad = 0
        return self.scale

    def state(self) -> dict:
        return {"plateau_best": self.best, "plateau_bad": float(self.num_bad),
                "plateau_scale": self.scale}

    def load(self, extra: dict) -> None:
        if "plateau_best" in extra:
            self.best = float(extra["plateau_best"])
            self.num_bad = int(extra.get("plateau_bad", 0))
            self.scale = float(extra.get("plateau_scale", 1.0))
