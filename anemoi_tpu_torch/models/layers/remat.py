"""Rematerialisation (activation checkpointing) policies.

Port of ``anemoi_tpu.models.layers.remat``.  The JAX package names the
attention kernels' ``out``/``lse`` with ``checkpoint_name`` and lets a
``jax.checkpoint`` policy keep them.  Here the kernels are ``torch.library``
ops -- ``anemoi_tpu_torch::gt_attention_fwd`` (K1/K2) and
``anemoi_tpu_torch::band_attention_fwd`` (K6) -- and a policy is a set of
ops whose outputs a non-reentrant ``torch.utils.checkpoint`` keeps
(``create_selective_checkpoint_contexts``); it recomputes every other op in
the backward.  A policy that keeps an attention op's outputs never runs
that op again in the backward.
"""

from __future__ import annotations

import functools
from typing import Callable, FrozenSet, Optional

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

# registers the ops below
import anemoi_tpu_torch.models.layers.mlp  # noqa: F401
import anemoi_tpu_torch.ops.gt_attention  # noqa: F401
import anemoi_tpu_torch.ops.window_attention  # noqa: F401

_OPS = torch.ops.anemoi_tpu_torch
# the ops whose (out, lse) the attention backward reads: the counterpart of
# the JAX package's ATTN_SAVE_NAMES
ATTN_SAVE_OPS = (_OPS.gt_attention_fwd.default, _OPS.band_attention_fwd.default)
MLP_HIDDEN_OP = _OPS.mlp_hidden.default
# the matrix products (JAX's dots_with_no_batch_dims_saveable; bmm as well)
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)

Policy = Optional[FrozenSet]


def resolve_remat_policy(name: Optional[str]) -> Policy:
    """The ops whose outputs a checkpoint keeps, by the config's name.

    - "full" / None: keep nothing, recompute the whole block in the backward
      (least memory; the forward attention kernel runs twice).
    - "save_attention": keep the attention ops' out/lse, recompute the rest.
    - "save_attention_mlp": also keep the ``[N, ratio * C]`` MLP hidden
      activation (``mlp_hidden``).
    - "dots": keep the matrix products' outputs, recompute everything else.
    """
    if name in (None, "full"):
        return None
    if name == "save_attention":
        return frozenset(ATTN_SAVE_OPS)
    if name == "save_attention_mlp":
        return frozenset((*ATTN_SAVE_OPS, MLP_HIDDEN_OP))
    if name == "dots":
        return frozenset(DOT_OPS)
    raise ValueError(
        f"unknown remat_policy {name!r}: "
        "expected full|save_attention|save_attention_mlp|dots"
    )


def checkpointed(fn: Callable, policy: Policy, *args):
    """``fn(*args)`` under a non-reentrant checkpoint that keeps the outputs
    of the ops in ``policy`` (from :func:`resolve_remat_policy`) and
    recomputes the rest in the backward."""
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, list(policy))
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _call(module: torch.nn.Module, params: dict, args: tuple):
    return torch.func.functional_call(module, params, args)


def checkpointed_module(module: torch.nn.Module, policy: Policy, *args):
    """``module(*args)`` under :func:`checkpointed`.  The module's parameters
    enter as inputs, as the tensors it holds at the call: under a
    ``functional_call`` (the training step's bf16 compute copies) the
    recompute in the backward reads those, not the float32 masters the
    module holds again by then."""
    return checkpointed(_call, policy, module, dict(module.named_parameters()), args)


class BlockRemat:
    """Mixin of the processors and mappers: run a block checkpointed under
    the component's ``remat_policy`` when ``gradient_checkpointing`` is on
    and autograd records.  The block is checkpointed where it is called,
    not wrapped, so its parameter names (``proc.<i>``) stay as they are."""

    def _init_remat(self, gradient_checkpointing: bool, remat_policy: Optional[str]) -> None:
        self.gradient_checkpointing = bool(gradient_checkpointing)
        self.remat_policy = resolve_remat_policy(remat_policy)

    def _run(self, block: torch.nn.Module, *args):
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpointed_module(block, self.remat_policy, *args)
        return block(*args)
