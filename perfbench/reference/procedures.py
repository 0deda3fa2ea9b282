"""The reference's training steps and forecast, and the comparisons that
decide ``correct``.  Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

from perfbench.reference.encprocdec import (
    Reference,
    adamw_update,
    lr_schedule,
    normalise,
    weighted_mse,
)


class Normaliser:
    """mean-std normalisation of the raw data space, and its inverse on the
    model's outputs."""

    def __init__(self, mean, std, ref: Reference, device):
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=device)
        self.inp = torch.as_tensor(ref.vars.input_idx, device=device)
        self.out = torch.as_tensor(ref.vars.output_idx, device=device)

    def __call__(self, raw: torch.Tensor) -> torch.Tensor:
        return normalise(raw, self.mean, self.std)

    def physical_output(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.std[self.out] + self.mean[self.out]


def train_steps(ref: Reference, w: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor],
                norm: Normaliser, area: torch.Tensor, opt: dict) -> dict:
    """``len(batches)`` training steps from the weights ``w`` (updated in
    place) on raw batches [B, m + 1, G, V]: per sample, the normalised inputs
    of the first m times and the next time's outputs as the target, the
    area-weighted MSE averaged over the batch (one sample at a time, its
    share of the gradient accumulated), every gradient element clipped to
    +-``clip``, then AdamW at the scheduled rate.  Returns each step's loss,
    the first step's clipped gradient norm and each tensor's change norm
    over the steps, by name."""
    for p in w.values():
        p.requires_grad_(True)
    start = {k: p.detach().clone() for k, p in w.items()}
    m = ref.m
    state: dict = {}
    losses: List[float] = []
    first_grad = None
    for step, batch in enumerate(batches):
        grads = {k: torch.zeros_like(p) for k, p in w.items()}
        total = 0.0
        for b in range(batch.shape[0]):
            x = norm(batch[b : b + 1].float())
            pred = ref.forward(w, x[:, :m][..., norm.inp])
            loss = weighted_mse(pred, x[:, m][..., norm.out], area) / batch.shape[0]
            got = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
            for (k, _), g in zip(w.items(), got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
        losses.append(total)
        for g in grads.values():
            g.clamp_(-opt["clip"], opt["clip"])
        if first_grad is None:  # as the optimizer gets it: clipped
            first_grad = {k: float(g.norm()) for k, g in grads.items()}
        lr = lr_schedule(step, opt["rate"], opt["min"], opt["warmup"], opt["iterations"])
        adamw_update(w, grads, state, step + 1, lr, opt["b1"], opt["b2"], opt["weight_decay"])
        del grads
    change = {k: float((p.detach() - start[k]).norm()) for k, p in w.items()}
    return {"losses": losses, "grad": first_grad, "change": change}


@torch.no_grad()
def forecast(ref: Reference, w: Dict[str, torch.Tensor], window: torch.Tensor,
             norm: Normaliser, steps: int) -> torch.Tensor:
    """``steps`` autoregressive steps from the raw window [1, m + steps, G,
    V]: the prognostic inputs from the previous step's output, the forcings
    from the window.  Returns the physical outputs [steps, G, V_out]."""
    m = ref.m
    x_norm = norm(window.float())
    x = x_norm[:, :m][..., norm.inp]
    prog_in = [i for i, n in enumerate(ref.vars.input_idx)
               if ref.vars.names[n] in ref.prog]
    out_pos = {ref.vars.names[n]: j for j, n in enumerate(ref.vars.output_idx)}
    from_out = [out_pos[ref.vars.names[ref.vars.input_idx[i]]] for i in prog_in]
    outs = []
    for step in range(steps):
        y = ref.forward(w, x)  # [1, G, V_out]
        outs.append(norm.physical_output(y)[0])
        new = x_norm[:, m + step][..., norm.inp].clone()
        new[..., prog_in] = y[..., from_out]
        x = torch.cat([x[:, 1:], new[:, None]], dim=1)
    return torch.stack(outs)


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Sequence[str]) -> tuple:
    """The worst leaf's gap between two norms: |program - reference| over
    the larger of the reference's norm of that leaf and of the median leaf.
    Returns (gap, leaf)."""
    median = statistics.median(reference[k] for k in keep)
    worst, leaf = 0.0, ""
    for k in keep:
        gap = abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= 1e-3 * median]


def training_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """The compared numbers of a training cell: the widest relative gap of
    the steps' losses, the worst leaf of the first gradient's norms, the
    worst leaf of the change's norms (moved leaves only)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"]))
    names = sorted(reference["grad"])
    grad, _ = leaf_gap(program["grad"], reference["grad"], names)
    change, _ = leaf_gap(program["change"], reference["change"], moved_leaves(reference["grad"]))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def forecast_gap(program: torch.Tensor, reference: torch.Tensor, mean, std) -> float:
    """The widest lead time's relative L2 gap of two forecasts [steps, G, V]
    in standardised units: |p - r| over |r - mean|."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=reference.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=reference.device)
    p = (program.to(reference.device).float() - mean) / std
    r = (reference.float() - mean) / std
    num = (p - r).flatten(1).norm(dim=1)
    den = r.flatten(1).norm(dim=1).clamp_min(1e-30)
    return float((num / den).max())
