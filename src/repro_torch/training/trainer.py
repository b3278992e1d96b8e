"""The train step (counterpart of ``repro.training.trainer``): loss (through
``models.api``) -> gradients by autograd -> clip -> optimizer, with optional
gradient accumulation over microbatches, int8 error-feedback cross-pod
gradient compression, and ProxSGD group-lasso regularization (the paper's
eq. (7)) reported every step.

The step runs eagerly on the parameters' device and **updates the state in
place** (the optimizers' contract): the ``TrainState`` it returns holds the
tensors it was given.  Its metrics are device tensors; nothing in the step
reads a value to the host.

**Under a mesh** (``make_train_step(mesh=...)``) the state is sharded
(:func:`repro_torch.distributed.placement.shard_state`): between steps each
rank holds only its chunk of each leaf, as ``state.pspecs`` says (FSDP /
ZeRO-3 storage).  A step gathers the parameters, takes this rank's part of
the batch (``batch_pspecs``), computes the gradients and averages them over
the batch axes with a float32 all-reduce (cast back to the gradients'
dtype), then clips and updates whole leaves (the optimizer state gathered
too) and keeps this rank's chunks.  With ``grad_compression`` the batch
splits over "pod" first; each pod averages its gradients within the pod,
then :func:`~repro_torch.distributed.compress_grads.compressed_psum` runs
across pods, as the reference's ``shard_map`` over "pod" does.  A mesh of
one rank runs the same code, its collectives through the process group.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_shard import manual_axes
from repro_torch.distributed.collectives import all_gather_dim, all_reduce
from repro_torch.distributed.compress_grads import compressed_psum, true_div
from repro_torch.distributed.placement import (chunk_slices, gather_tree,
                                               local_batch)
from repro_torch.distributed.sharding import map_specs, params_pspecs
from repro_torch.models import api
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map, zip_leaves)

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "record_step_metrics"]


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
    error_fb: Any | None = None  # gradient-compression residuals, [n_pods, ...]
    prox_report: Any | None = None  # per-site sparsity/group-norm summary
    # the spec tree of a state sharded over a mesh (its leaves hold this
    # rank's chunks); None for whole leaves.  Not a leaf: checkpoints and
    # spec trees leave it out.
    pspecs: Any | None = field(default=None, metadata={"static": True})


def init_train_state(seed: int, cfg: ArchConfig, optimizer: Optimizer,
                     grad_compression: bool = False, n_pods: int = 2,
                     prox_specs=None, device="cuda") -> TrainState:
    """Parameters from ``api.init_params(seed, cfg)`` on ``device``, the
    optimizer's state, step 0, with ``grad_compression`` the residuals
    (float32 zeros ``[n_pods, *shape]`` a parameter: one row a pod, as in
    the reference, whose default of 2 does not follow the mesh) and, under
    ProxSGD, the initial sparsity report."""
    params = api.init_params(seed, cfg, device)
    efb = tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                         dtype=torch.float32, device=device),
                   params) if grad_compression else None
    report = None
    if prox_specs:
        from repro_torch.training.regularize import sparsity_report
        report = sparsity_report(params, prox_specs)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      error_fb=efb, prox_report=report)


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                    lr: float = 3e-4, grad_clip: float = 1.0,
                    accum_steps: int = 1, grad_compression: bool = False,
                    mesh=None, prox_specs=None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` ``[B, S]`` on the parameters'
    device (under a mesh: the whole global batch on every rank).  With
    ``accum_steps > 1`` the batch splits into that many microbatches along
    B; their gradients sum in float32 and are averaged (float32 gradients
    then reach the clip and the optimizer, as in the reference).  ``mesh``
    (a :class:`repro_torch.distributed.Mesh`) makes the step sharded (see
    the module docstring); ``grad_compression`` needs a mesh with a "pod"
    axis and, as in the reference, takes no accumulation.  ``metrics``:
    ``loss``, ``grad_norm`` and, with ``prox_specs``, ``dead_groups`` and
    ``prox_penalty`` — device tensors, the same on every rank.
    """
    if grad_compression and (mesh is None or "pod" not in mesh.shape):
        raise ValueError("grad compression targets the cross-pod all-reduce; "
                         "need a pod axis")
    if mesh is not None and cfg.moe is not None and cfg.moe_manual:
        raise NotImplementedError(
            "moe_manual under the train step's mesh: its backward needs a "
            "differentiable all-reduce over 'model' (ROADMAP A7c)")

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

    def apply_update(state: TrainState, loss, grads):
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

    if mesh is None:
        def step(state: TrainState, batch):
            loss, grads = grads_of(state.params, batch)
            return apply_update(state, loss, grads)
        return step
    return _meshed_step(mesh, grad_compression, value_and_grad, grads_of,
                        apply_update)


def _meshed_step(mesh, grad_compression, value_and_grad, grads_of,
                 apply_update):
    """The sharded step over ``mesh`` (see the module docstring)."""
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")

    def mean_over(x, axes):
        """The float32 mean of ``x`` over the mesh axes, in ``x``'s dtype."""
        if not axes:
            return x
        x32 = x.detach().to(torch.float32, copy=True)
        for a in reversed(axes):
            all_reduce(x32, mesh.group(a))
        return true_div(x32, float(math.prod(mesh.shape[a] for a in axes))
                        ).to(x.dtype)

    def pod_grads(whole: TrainState, batch):
        """Per-pod gradients averaged within the pod, then the int8
        error-feedback all-reduce across pods.  Returns (loss, mean grads,
        residuals ``[n_pods, ...]``)."""
        n_pods, pod = mesh.shape["pod"], mesh.coord("pod")
        podded = {k: v.reshape(n_pods, v.shape[0] // n_pods, *v.shape[1:])[pod]
                  for k, v in batch.items()}
        local, axes = local_batch(podded, mesh, axes=("data",))
        loss, grads = value_and_grad(whole.params, local)
        grads = tree_map(lambda g: mean_over(g, axes), grads)
        loss = mean_over(loss, axes)
        lead = tree_leaves(whole.error_fb)[0].shape[0]
        if lead % n_pods:
            raise ValueError(f"the residuals' leading {lead} rows do not split "
                             f"over {n_pods} pods")
        # the rows a pod's block starts with, as shard_map's P("pod") split
        rows = tree_map(lambda e: e[pod * (lead // n_pods)], whole.error_fb)
        with manual_axes("pod"):
            grads, new_e = compressed_psum(grads, rows, mesh.group("pod"))
        efb = tree_map(lambda e: all_gather_dim(e[None], mesh.group("pod"), 0),
                       new_e)
        return mean_over(loss, ("pod",)), grads, efb

    @torch.no_grad()
    def keep_chunks(whole: TrainState, specs) -> TrainState:
        return dataclasses.replace(
            map_specs(lambda x, s: x[chunk_slices(x.shape, s, mesh)].clone(
                memory_format=torch.contiguous_format), whole, specs),
            pspecs=specs)

    def step(state: TrainState, batch):
        specs = state.pspecs
        if specs is None:
            raise ValueError("a meshed step takes a sharded state: "
                             "distributed.placement.shard_state(state, mesh)")
        whole = gather_tree(state, specs, mesh)
        if grad_compression:
            loss, grads, efb = pod_grads(whole, batch)
            whole = dataclasses.replace(whole, error_fb=efb)
            specs = dataclasses.replace(specs, error_fb=params_pspecs(
                efb, mesh, prefix=(".error_fb",)))
        else:
            local, axes = local_batch(batch, mesh)
            loss, grads = grads_of(whole.params, local)
            grads = tree_map(lambda g: mean_over(g, axes), grads)
            loss = mean_over(loss, axes)
        new, metrics = apply_update(whole, loss, grads)
        return keep_chunks(new, specs), metrics

    return step
