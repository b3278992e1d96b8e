"""The train step (counterpart of ``repro.training.trainer``): loss (through
``models.api``) -> gradients by autograd -> clip -> optimizer, with optional
gradient accumulation over microbatches and ProxSGD group-lasso
regularization (the paper's eq. (7)) reported every step.

The step runs eagerly on the parameters' device and **updates the state in
place** (the optimizers' contract): the ``TrainState`` it returns holds the
tensors it was given.  Its metrics are device tensors; nothing in the step
reads a value to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map, zip_leaves)

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "record_step_metrics"]

_DISTRIBUTED = ("is not available in this package yet: the trainer's mesh and "
                "int8 cross-pod gradient compression come with the "
                "distributed/ entry of ROADMAP Queue A")


def record_step_metrics(registry, metrics: dict, *, step=None) -> None:
    """Publish one train step's metric dict (``loss``, ``grad_norm``, and —
    under ProxSGD — ``dead_groups`` / ``prox_penalty``) into a
    :mod:`repro_torch.obs` registry as ``train_<name>`` gauges plus the
    ``train_steps_total`` counter.  Values may still be device tensors: each
    ``float()`` reads one to the host, so call this where the loop already
    reads them (where it prints) and telemetry never forces a sync of its
    own."""
    if registry is None:
        return
    registry.counter("train_steps_total", "recorded train steps").inc()
    if step is not None:
        registry.gauge("train_step", "last recorded optimizer step").set(
            int(step))
    for k, v in metrics.items():
        try:
            fv = float(v)
        except (TypeError, ValueError):
            continue  # non-scalar extras stay out of the registry
        registry.gauge(f"train_{k}", f"train step metric {k!r}").set(fv)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # 0-d int32 on the parameters' device
    error_fb: Any | None = None  # gradient-compression residuals (not ported)
    prox_report: Any | None = None  # per-site sparsity/group-norm summary


def init_train_state(seed: int, cfg: ArchConfig, optimizer: Optimizer,
                     prox_specs=None, device="cuda") -> TrainState:
    """Parameters from ``api.init_params(seed, cfg)`` on ``device``, the
    optimizer's state, step 0 and, under ProxSGD, the initial sparsity
    report."""
    params = api.init_params(seed, cfg, device)
    report = None
    if prox_specs:
        from repro_torch.training.regularize import sparsity_report
        report = sparsity_report(params, prox_specs)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      prox_report=report)


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                    lr: float = 3e-4, grad_clip: float = 1.0,
                    accum_steps: int = 1, grad_compression: bool = False,
                    mesh=None, prox_specs=None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` ``[B, S]`` on the parameters'
    device.  With ``accum_steps > 1`` the batch splits into that many
    microbatches along B; their gradients sum in float32 and are averaged
    (float32 gradients then reach the clip and the optimizer, as in the
    reference).  ``metrics``: ``loss``, ``grad_norm`` and, with
    ``prox_specs``, ``dead_groups`` and ``prox_penalty`` — device tensors.
    """
    if grad_compression:
        raise NotImplementedError(f"grad_compression {_DISTRIBUTED}")
    if mesh is not None:
        raise NotImplementedError(f"mesh= {_DISTRIBUTED}")

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = api.train_loss(params, cfg, batch)
        # a leaf the loss does not read (olmo's non-parametric norms) gets a
        # zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def grads_of(params, batch):
        if accum_steps == 1:
            return value_and_grad(params, batch)
        micros = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                               *v.shape[1:]) for k, v in batch.items()}
        tot_l = None
        tot_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(accum_steps):
            loss, g = value_and_grad(params, {k: v[i] for k, v in micros.items()})
            tot_l = loss.to(torch.float32) if tot_l is None else tot_l + loss
            for acc, gi in zip_leaves(tot_g, g):
                acc.add_(gi)
        for acc in tree_leaves(tot_g):
            acc.div_(accum_steps)
        return tot_l / accum_steps, tot_g

    def step(state: TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm}
        report = state.prox_report
        if prox_specs:
            from repro_torch.training.regularize import sparsity_report
            report = sparsity_report(params, prox_specs)
            metrics["dead_groups"] = sum(v["dead"] for v in report.values())
            metrics["prox_penalty"] = sum(v["penalty"] for v in report.values())
        new = TrainState(params=params, opt_state=opt_state,
                         step=state.step + 1, error_fb=state.error_fb,
                         prox_report=report)
        return new, metrics

    return step
