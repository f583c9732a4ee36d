"""Optimizers and LR schedulers (port of evoke_tpu/train/optim.py).

The JAX package builds an optax chain per parameter group, in this order:
``clip`` by value, ``add_decayed_weights`` (L2 into the gradient, torch's
Adam semantics, not decoupled AdamW), ``scale_by_radam`` or
``scale_by_amsgrad``, then ``-lr * lr_scale``; ``grad_accum_steps > 1``
wraps the chain in ``optax.MultiSteps``. ``Optimizer`` computes the same
functions on tensors, group by group, with ``torch._foreach_*`` ops. It is not
``torch.optim.RAdam`` or ``torch.optim.Adam(amsgrad=True)``, which compute
other functions: optax's AMSGrad takes the max of the bias-corrected second
moment, and optax's RAdam rectifies when ``ro >= 5`` and adds ``eps`` after
the bias correction.

The step's scalars (bias corrections, the rectification) are computed on the
host in float32 as XLA computes them (``decay ** count`` rounded from a
float64 power), so no device value is read. The optimizer keeps float32
master copies of parameters stored in a lower precision (a bf16 model) and
writes the rounded result back into the model after each update, as the JAX
package's float32 params are cast to the compute dtype in every use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

FT_GROUP_SUBSTRINGS = ("text_decoder", "visual_self_atten", "multimodal_fusion",
                       "visual_head", "text_head")
OPTIMIZERS = ("RAdam", "AdamW")      # the reference's 'AdamW' is Adam(amsgrad=True)

B1, B2, EPS = 0.9, 0.999, 1e-8       # optax's defaults for both scalers
RADAM_THRESHOLD = 5.0


def param_label(name: str) -> str:
    """'ft' if a parameter's name holds a new-module name, else 'pt'."""
    return "ft" if any(s in name for s in FT_GROUP_SUBSTRINGS) else "pt"


f32 = np.float32


def _pow(decay: float, count: int) -> np.float32:
    """float32 ``decay ** count`` as XLA rounds it (a float64 power rounded)."""
    return f32(math.pow(f32(decay), count))


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count`` in float32."""
    return float(f32(1.0) - _pow(decay, count))


def radam_scalars(count: int):
    """(rectify, r) of optax's scale_by_radam at ``count``, float32 on the
    host in optax's order of operations (its Python-float constants are
    float64 until they meet a float32 value)."""
    ro_inf = 2.0 / (1.0 - B2) - 1.0
    b2t = _pow(B2, count)
    ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1.0) - b2t)
    if not ro >= RADAM_THRESHOLD:
        return False, None
    denom = f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro
    r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf) / denom)
    return True, float(r)


@dataclass
class Group:
    lr: float
    names: List[str]
    params: List[torch.Tensor]          # the model's parameters
    master: List[torch.Tensor]          # float32 (the parameter itself when float32)
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)
    nu_max: List[torch.Tensor] = field(default_factory=list)
    acc: List[torch.Tensor] = field(default_factory=list)


class Optimizer:
    """The optax chain of ``evoke_tpu.train.optim.build_optimizer`` on tensors.

    Parameters are grouped by name (``Group``: a learning rate, the model's
    parameters, their float32 masters and moments). ``step(grads)`` updates
    the masters in place and copies them into the model's parameters where
    those are stored in a lower precision. ``lr_scale`` is a host float read
    at each update."""

    def __init__(self, optim_name: str, groups: Dict[str, Group], weight_decay: float,
                 grad_clip_value: float = 0.1, grad_accum_steps: int = 1):
        if optim_name not in OPTIMIZERS:
            raise ValueError(f"optim.optim={optim_name!r}: one of {OPTIMIZERS}")
        self.optim_name = optim_name
        self.groups = groups
        self.weight_decay = float(weight_decay)
        self.clip = float(grad_clip_value)
        self.accum = max(int(grad_accum_steps), 1)
        self.lr_scale = 1.0
        self.count = 0          # the scaler's count (optax: inner count, int32)
        self.mini_step = 0      # MultiSteps' position inside an accumulation
        for g in groups.values():
            g.mu = [torch.zeros_like(m) for m in g.master]
            g.nu = [torch.zeros_like(m) for m in g.master]
            if optim_name != "RAdam":
                g.nu_max = [torch.zeros_like(m) for m in g.master]
            if self.accum > 1:
                g.acc = [torch.zeros_like(m) for m in g.master]

    # ---- the update ----

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> bool:
        """One call of the chain on ``grads`` (name -> tensor; a missing or
        None gradient counts as zero, as JAX's zero cotangent of an unused
        parameter). Returns whether the parameters moved: False on the
        accumulation calls of ``grad_accum_steps > 1`` (optax.MultiSteps,
        whose updates there are zero)."""
        emit = self.mini_step == self.accum - 1
        per_group = {}
        for label, g in self.groups.items():
            gs = [grads[n].float() if grads.get(n) is not None else torch.zeros_like(m)
                  for n, m in zip(g.names, g.master)]
            if self.accum > 1:
                # MultiSteps' running mean: acc + (g - acc) / (n + 1)
                diff = torch._foreach_sub(gs, g.acc)
                torch._foreach_div_(diff, float(self.mini_step + 1))
                torch._foreach_add_(g.acc, diff)
                gs = g.acc
            per_group[label] = gs
        if not emit:
            self.mini_step += 1
            return False
        self.mini_step = 0
        self.count += 1
        for label, g in self.groups.items():
            self._update_group(g, per_group[label])
            if self.accum > 1:
                torch._foreach_zero_(g.acc)
        return True

    def _update_group(self, g: Group, gs: List[torch.Tensor]) -> None:
        c = self.clip
        u = torch._foreach_clamp_max(torch._foreach_clamp_min(gs, -c), c)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(g.master, self.weight_decay))
        t = torch._foreach_mul(u, 1 - B1)
        torch._foreach_mul_(g.mu, B1)
        torch._foreach_add_(g.mu, t)
        t = torch._foreach_mul(u, u)
        torch._foreach_mul_(t, 1 - B2)
        torch._foreach_mul_(g.nu, B2)
        torch._foreach_add_(g.nu, t)
        del t, u
        n = self.count
        mu_hat = torch._foreach_div(g.mu, _bias_correction(B1, n))
        nu_hat = torch._foreach_div(g.nu, _bias_correction(B2, n))
        if self.optim_name == "RAdam":
            rectify, r = radam_scalars(n)
            if rectify:
                upd = torch._foreach_mul(mu_hat, r)
                den = torch._foreach_sqrt(nu_hat)
                torch._foreach_add_(den, EPS)
                torch._foreach_div_(upd, den)
            else:
                upd = mu_hat
        else:
            torch._foreach_maximum_(g.nu_max, nu_hat)
            den = torch._foreach_sqrt(g.nu_max)
            torch._foreach_add_(den, EPS)
            upd = torch._foreach_div(mu_hat, den)
        # optax.scale(-1), then scale_by_learning_rate(lr * lr_scale): one
        # float32 step size
        torch._foreach_mul_(upd, -float(f32(g.lr) * f32(self.lr_scale)))
        torch._foreach_add_(g.master, upd)
        low = [(p, m) for p, m in zip(g.params, g.master) if p.dtype != m.dtype]
        if low:
            torch._foreach_copy_([p.data for p, _ in low], [m for _, m in low])

    # ---- checkpoints ----

    def state_dict(self) -> Dict[str, Any]:
        """Counters, ``lr_scale`` and the moment tensors by parameter name
        (the masters are the run's parameters; the caller saves them)."""
        slots = {"mu": {}, "nu": {}, "nu_max": {}, "acc": {}}
        for g in self.groups.values():
            for slot, tensors in slots.items():
                tensors.update(zip(g.names, getattr(g, slot)))
        return {"optim": self.optim_name, "count": self.count, "mini_step": self.mini_step,
                "lr_scale": self.lr_scale, **{k: v for k, v in slots.items() if v}}

    @torch.no_grad()
    def load_state_dict(self, d: Mapping[str, Any]) -> None:
        if d["optim"] != self.optim_name:
            raise ValueError(f"checkpoint optimizer {d['optim']!r} != {self.optim_name!r}")
        self.count, self.mini_step = int(d["count"]), int(d["mini_step"])
        self.lr_scale = float(d["lr_scale"])
        for g in self.groups.values():
            for slot in ("mu", "nu", "nu_max", "acc"):
                for n, t in zip(g.names, getattr(g, slot)):
                    t.copy_(d[slot][n])

    def masters(self) -> Dict[str, torch.Tensor]:
        """name -> the float32 parameter the optimizer updates."""
        return {n: m for g in self.groups.values() for n, m in zip(g.names, g.master)}

    @torch.no_grad()
    def load_masters(self, values: Mapping[str, Any]) -> None:
        """Copy the float32 values named in ``values`` into the masters and
        the model's parameters (rounded to their dtype)."""
        for g in self.groups.values():
            for n, p, m in zip(g.names, g.params, g.master):
                if n in values:
                    m.copy_(torch.as_tensor(values[n]))
                    if p.dtype != m.dtype:
                        p.data.copy_(m)


def build_optimizer(optim_name: str, task: str, model: torch.nn.Module, pt_lr: float,
                    ft_lr: float, weight_decay: float, grad_clip_value: float = 0.1,
                    grad_accum_steps: int = 1) -> Optimizer:
    """The finetune task's two groups (``FT_GROUP_SUBSTRINGS`` at ``ft_lr``,
    the rest at ``pt_lr``) or one group at ``pt_lr``, over ``model``'s
    parameters in ``named_parameters`` order."""
    groups: Dict[str, Group] = {}
    for name, p in model.named_parameters():
        label = param_label(name) if task == "finetune" else "pt"
        if label not in groups:
            groups[label] = Group(lr=ft_lr if label == "ft" else pt_lr, names=[], params=[],
                                  master=[])
        g = groups[label]
        g.names.append(name)
        g.params.append(p)
        g.master.append(p.detach() if p.dtype == torch.float32
                        else p.detach().float().clone())
    return Optimizer(optim_name, groups, weight_decay, grad_clip_value, grad_accum_steps)


def set_lr_scale(opt: Optimizer, scale: float) -> Optimizer:
    """Set the ``lr_scale`` the next updates read (a host float: nothing is
    rebuilt or re-captured)."""
    opt.lr_scale = float(scale)
    return opt


@dataclass
class StepScheduler:
    """StepLR: scale = gamma ** (epoch // step_size)."""

    step_size: int = 10
    gamma: float = 0.5

    def scale_for_epoch(self, epoch: int, metric: float | None = None) -> float:
        return self.gamma ** (epoch // self.step_size)

    def update(self, epoch: int, metric: float | None = None) -> float:
        return self.scale_for_epoch(epoch)


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (torch defaults: factor 0.1, patience 10, rel threshold 1e-4)."""

    mode: str = "min"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_scale: float = 1e-8
    _scale: float = field(default=1.0, init=False)
    _best: float | None = field(default=None, init=False)
    _bad_epochs: int = field(default=0, init=False)

    def _is_better(self, metric: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return metric < self._best * (1.0 - self.threshold)
        return metric > self._best * (1.0 + self.threshold)

    def update(self, epoch: int, metric: float | None = None) -> float:
        if metric is None:
            return self._scale
        if self._is_better(metric):
            self._best = metric
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self._scale = max(self._scale * self.factor, self.min_scale)
                self._bad_epochs = 0
        return self._scale

    def state_dict(self) -> Dict[str, Any]:
        return {"scale": self._scale, "best": self._best, "bad_epochs": self._bad_epochs}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self._scale = d["scale"]
        self._best = d["best"]
        self._bad_epochs = d["bad_epochs"]


@dataclass
class WarmupCosineScheduler:
    """LinearWarmupCosineAnnealing (reference models/schedulers/*.py parity):
    linear 0 -> 1 over warmup_epochs, then cosine to min_scale at max_epochs."""

    warmup_epochs: int = 5
    max_epochs: int = 50
    min_scale: float = 0.0

    def update(self, epoch: int, metric: float | None = None) -> float:
        if epoch < self.warmup_epochs:
            return max(epoch / max(self.warmup_epochs, 1), 1e-8)
        t = min((epoch - self.warmup_epochs) /
                max(self.max_epochs - self.warmup_epochs, 1), 1.0)
        return self.min_scale + (1 - self.min_scale) * 0.5 * (1 + math.cos(math.pi * t))


def build_scheduler(name: str, mode: str, step_size: int = 10, gamma: float = 0.5,
                    warmup_epochs: int = 5, max_epochs: int = 50):
    if name == "StepLR":
        return StepScheduler(step_size=step_size, gamma=gamma)
    if name == "WarmupCosine":
        return WarmupCosineScheduler(warmup_epochs=warmup_epochs, max_epochs=max_epochs)
    return PlateauScheduler(mode=mode)
