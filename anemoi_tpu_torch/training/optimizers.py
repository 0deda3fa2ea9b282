"""Optimizers and learning-rate schedules.

Port of ``anemoi_tpu.training.optimizers``: ``build_lr_schedule`` (optax's
``warmup_cosine_decay_schedule``, in plain Python) and ``build_optimizer``
(``adamw``/``adam`` on ``torch.optim`` with the JAX registry's defaults, and
``ademamix``, :class:`AdEMAMix`, after value or global-norm gradient
clipping).

As in optax, the schedule is read at the update count *before* it is
incremented: the first update uses ``schedule(0)``, which is 0 with warmup.

``optimizer.zero`` (ZeRO-1, JAX ``mesh.zero_sharding``) over a data group of
D ranks: the state of every parameter whose first axis divides by D is kept
for one block of ``rows / D`` rows per rank; each rank updates its block and
the updated blocks are gathered into the parameter.  The update is
elementwise, so it is the unsharded one; the rest stays replicated.
:meth:`Optimizer.state_dict` gathers the blocks (every rank takes part).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from anemoi_tpu_torch.parallel.distributed import RowShard, all_gather, fetch_replicated
from anemoi_tpu_torch.parallel.mesh import zero_sharding
from anemoi_tpu_torch.utils.tracing import span

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0, exponent: float = 1.0,
) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (which includes the warmup) -- optax's formula."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * decay**exponent + alpha)

    return schedule


def build_lr_schedule(config: dict) -> Schedule:
    """Warmup + cosine annealing to the minimum rate (config ``training.lr``:
    ``rate``, ``min``, ``warmup``, ``iterations``)."""
    rate = float(config.get("rate", 1e-4))
    min_rate = float(config.get("min", 3e-7))
    warmup = int(config.get("warmup", 1000))
    iterations = int(config.get("iterations", 300000))
    return warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=rate, warmup_steps=max(warmup, 1),
        decay_steps=max(iterations, warmup + 1), end_value=min_rate,
    )


# ``eps`` (and every other key but ``zero``) is swallowed as the JAX factories
# swallow it: optax keeps its 1e-8, torch's default is the same
def _adamw(params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.95, **_):
    return torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), weight_decay=weight_decay)


def _adam(params, b1: float = 0.9, b2: float = 0.95, **_):
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2))


class AdEMAMix(torch.optim.Optimizer):
    """AdEMAMix (Pagliardini et al. 2024), as the JAX package chains it in
    optax: Adam with a slow EMA ``m2`` mixed into the update,

        u = (m1_hat + alpha_t * m2) / (sqrt(nu_hat) + eps)

    with ``alpha_t`` warmed up linearly from 0 over ``alpha_warmup`` updates
    and ``b3_t`` from ``b1`` to ``b3`` over ``b3_warmup`` updates (linear in
    the log half-life); then ``u + weight_decay * p``, scaled by the rate.
    The state of each parameter: ``m1``, ``m2``, ``nu`` (float32) and the
    update ``count``."""

    def __init__(self, params, lr: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 b3: float = 0.9999, alpha: float = 5.0, b3_warmup: Optional[int] = None,
                 alpha_warmup: Optional[int] = None, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, b3=b3, alpha=alpha,
                                      b3_warmup=b3_warmup, alpha_warmup=alpha_warmup, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def _b3(count: int, b1: float, b3: float, warmup: Optional[int]) -> float:
        if warmup is None:
            return b3

        def log_half_life(beta):
            return math.log(0.5) / math.log(beta) - 1.0

        frac = min(max(count / warmup, 0.0), 1.0)
        hl = (1.0 - frac) * log_half_life(b1) + frac * log_half_life(b3)
        return math.exp(math.log(0.5) / (hl + 1.0))

    @staticmethod
    def _alpha(count: int, alpha: float, warmup: Optional[int]) -> float:
        if warmup is None:
            return alpha
        return min(max(count / warmup, 0.0), 1.0) * alpha

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    for key in ("m1", "m2", "nu"):
                        state[key] = torch.zeros_like(p, dtype=torch.float32)
                state["count"] += 1
                count = state["count"]
                b3 = self._b3(count, b1, group["b3"], group["b3_warmup"])
                alpha = self._alpha(count, group["alpha"], group["alpha_warmup"])
                m1, m2, nu = state["m1"], state["m2"], state["nu"]
                m1.mul_(b1).add_(g, alpha=1 - b1)
                m2.mul_(b3).add_(g, alpha=1 - b3)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (nu / (1 - b2**count)).sqrt_().add_(eps)
                update = (m1 / (1 - b1**count)).add_(m2, alpha=alpha).div_(denom)
                if group["weight_decay"]:
                    update.add_(p, alpha=group["weight_decay"])
                p.add_(update.to(p.dtype), alpha=-group["lr"])
        return None


def _ademamix(params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
              b3: float = 0.9999, alpha: float = 5.0, b3_warmup: Optional[int] = None,
              alpha_warmup: Optional[int] = None, **_):
    return AdEMAMix(params, lr=0.0, b1=b1, b2=b2, b3=b3, alpha=alpha, b3_warmup=b3_warmup,
                    alpha_warmup=alpha_warmup, weight_decay=weight_decay)


OPTIMIZERS = {"adamw": _adamw, "adam": _adam, "ademamix": _ademamix}


class Optimizer:
    """Gradient clipping, then a ``torch.optim`` update at the scheduled rate.
    :meth:`step` updates the parameters in place from their ``.grad``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], name: str, options: dict,
                 schedule: Schedule, clip_value: float = 0.0, clip_norm: float = 0.0,
                 zero_group=None) -> None:
        self.params = [p for p in params if p.requires_grad]
        self.zero_group = zero_group
        # per parameter: its ZeRO block (a view of its rows) or None
        self.blocks = [self._block(p) for p in self.params]
        self.opt = OPTIMIZERS[name](
            [p if b is None else b for p, b in zip(self.params, self.blocks)], **options)
        self.schedule = schedule
        self.clip_value = clip_value
        self.clip_norm = clip_norm
        self.count = 0  # updates applied so far
        self.frozen: list = []  # parameters whose update is zeroed (:meth:`freeze`)

    def freeze(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Zero the update of ``params`` after every step, as the JAX trainer
        chains ``optax.masked(set_to_zero)`` after the optimizer for the
        checkpoint pipeline's ``freeze``: their gradients, clipping and
        optimizer state go on as before, and the weights stay bit for bit,
        weight decay included."""
        self.frozen = list(params)

    def _block(self, p: torch.nn.Parameter) -> Optional[torch.Tensor]:
        group = self.zero_group
        if group is None:
            return None
        size = torch.distributed.get_world_size(group)
        if not zero_sharding(p.shape, size):
            return None
        rows = p.shape[0] // size
        block = p.data.narrow(0, torch.distributed.get_rank(group) * rows, rows)
        return block.requires_grad_(True)

    def step(self) -> None:
        """Clip (span ``anemoi.optim.clip``), then update (``anemoi.optim.update``)."""
        with span("anemoi.optim.clip"):
            if self.clip_value > 0:
                torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
            elif self.clip_norm > 0:
                torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        with span("anemoi.optim.update"):
            lr = self.schedule(self.count)
            for group in self.opt.param_groups:
                group["lr"] = lr
            for p, block in zip(self.params, self.blocks):
                if block is not None:
                    block.grad = None if p.grad is None else self._rows(p.grad, block)
            kept = [p.detach().clone() for p in self.frozen]
            self.opt.step()
            with torch.no_grad():
                for p, block in zip(self.params, self.blocks):
                    if block is not None:
                        p.data.copy_(torch.cat(all_gather(block.detach(), self.zero_group), 0))
                for p, weights in zip(self.frozen, kept):
                    p.copy_(weights)
            self.count += 1

    def _rows(self, full: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
        """This rank's block of rows of a parameter-shaped tensor."""
        rows = block.shape[0]
        return full.narrow(0, torch.distributed.get_rank(self.zero_group) * rows, rows)

    def state_dict(self) -> dict:
        """The torch optimizer's state dict, with ZeRO blocks gathered whole
        (collective over the data group: every rank calls it)."""
        sd = self.opt.state_dict()
        if self.zero_group is not None:
            state = {}
            for i, st in sd["state"].items():
                block = self.blocks[i]
                state[i] = {k: RowShard(v, self.zero_group)
                            if block is not None and torch.is_tensor(v) and v.dim() > 0
                            and v.shape == block.shape else v for k, v in st.items()}
            sd = {**sd, "state": state}
        return fetch_replicated(sd)

    def load_state_dict(self, sd: dict) -> None:
        """Load a whole state dict (:meth:`state_dict`), each rank keeping
        its ZeRO blocks."""
        if self.zero_group is not None:
            state = {}
            for i, st in sd["state"].items():
                block, p = self.blocks[int(i)], self.params[int(i)]
                state[i] = {k: self._rows(v, block).clone()
                            if block is not None and torch.is_tensor(v) and v.shape == p.shape
                            else v for k, v in st.items()}
            sd = {**sd, "state": state}
        self.opt.load_state_dict(sd)


def build_optimizer(config: dict, schedule: Optional[Schedule] = None, data_group=None):
    """``config``: ``{"optimizer": {"name": "adamw", "zero": false, ...},
    "lr": {...}, "gradient_clip": {"val": 32.0, "algorithm": "value" |
    "norm"}}``.  Returns a factory ``params -> Optimizer`` (what
    ``TrainState.create`` takes, as the JAX ``TrainState.create`` takes an
    optax transformation).  ``zero`` shards the state over ``data_group``
    (no effect without one, as in the JAX trainer without a mesh)."""
    cfg = dict(config.get("optimizer", {"name": "adamw"}))
    name = cfg.pop("name", "adamw")
    zero_group = data_group if bool(cfg.pop("zero", False)) else None
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer '{name}' is not ported to anemoi_tpu_torch")
    lr = schedule if schedule is not None else build_lr_schedule(config.get("lr", {}))
    clip = config.get("gradient_clip") or {}
    val = float(clip.get("val", 0.0))
    algorithm = clip.get("algorithm", "value")
    if algorithm not in ("value", "norm"):
        raise ValueError(f"unknown gradient_clip algorithm '{algorithm}'")

    def make(params: Iterable[torch.nn.Parameter]) -> Optimizer:
        return Optimizer(
            params, name, cfg, lr,
            clip_value=val if algorithm == "value" else 0.0,
            clip_norm=val if algorithm == "norm" else 0.0, zero_group=zero_group,
        )

    return make
