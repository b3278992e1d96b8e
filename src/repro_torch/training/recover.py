"""Post-compression recovery fine-tuning on a :class:`CompressedModel`
(counterpart of ``repro.training.recover``).

The paper's eq. (9) retrains tied (shared) weights after clustering; Deep
Compression shows the same prune -> retrain loop is where most of the
compression ratio survives.  Here recovery runs *after* LCC decomposition, on
the artifact itself: the frozen shift-add chains stay bitwise-fixed and a
trainable **dense residual in codebook space** rides on top.

Per dense unit the residual ``delta`` has shape [N, C] where C is the packed
decomposition's input width — the shared codebook size for weight-shared
sites, the kept-column count otherwise.  The training-time effective map is

    W_eff = W_frozen + delta[:, labels]        (shared: cluster-tied, eq. (9))
    W_eff = W_frozen + delta                   (unshared)

built through ``compress_adapters.rebind_site_traced`` so the loss is the
family's own forward on the rebound params; ``torch.autograd`` carries the
gradient straight through the frozen base to ``delta`` (the straight-through
estimator — the chains act as a constant).  For shared sites
``delta[:, labels]`` makes every column of a cluster share one residual
column, so its gradient is the *sum over the cluster* — exactly the
tied-weight gradient of eq. (9).  The deltas are float32 tensors on the
device of the artifact's params; the optimizer updates them in place, as
every optimizer of this package updates its params.

``write_back`` sparsifies the trained residual under an adds budget (CSD
adds of the residual <= ``residual_frac`` x the unit's LCC adds), then writes
it into every artifact surface at once — ``records[*].effective``, an extra
dense slice on the packed decomposition (``apply_packed_decomposition`` adds
dense slices on top of the fused chains, so serving is exact; the packed
object is a new one, with no device copy yet), the dense-effective
``params``, and the cost report (``stage_adds['recover']``).
``ServingEngine(artifact=...)`` then serves the recovered model unchanged.

Note: ``CompressedDense.apply`` (the numpy decomposition-only reference path)
does not see the residual; the artifact's effective/params/packed surfaces —
everything serving reads — do.  Nor does an artifact's layer plan
(``artifact.plans``) packed before recovery: ``write_back`` leaves it as it
is, as the reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.compress import CompressedDense
from repro_torch.core.csd import adds_csd_matrix
from repro_torch.models import compress_adapters
from repro_torch.optim.optimizers import adamw, tree_leaves

__all__ = ["RecoverState", "recoverable_sites", "make_recover_step",
           "recover_artifact", "write_back", "init_deltas"]


@dataclass
class RecoverState:
    deltas: dict[str, torch.Tensor]  # unit name -> [N, C] codebook-space residual
    opt_state: Any
    step: int


def recoverable_sites(artifact) -> list[tuple[Any, CompressedDense]]:
    """Dense sites of the artifact's family that have a compressed record —
    the units recovery can fine-tune (conv records stay frozen)."""
    sites = compress_adapters.sites_for(artifact.params, artifact.config)
    out = []
    for s in sites:
        rec = artifact.records.get(s.name)
        if isinstance(s, compress_adapters.DenseSite) and \
                isinstance(rec, CompressedDense):
            out.append((s, rec))
    return out


def _site_weight_traced(params, site) -> torch.Tensor:
    """Tensor mirror of ``DenseSite.weight``: the [N, K] y = W x view."""
    a = params
    for k in site.path:
        a = a[k]
    for i in site.index:
        a = a[i]
    return a.transpose(-1, -2) if site.transpose else a


def _expand_delta(delta: torch.Tensor, rec: CompressedDense,
                  k_orig: int) -> torch.Tensor:
    """[N, C] codebook residual -> [N, K_orig] original input space."""
    dev = delta.device
    dk = delta[:, torch.as_tensor(np.asarray(rec.shared.labels), dtype=torch.long,
                                  device=dev)] \
        if rec.shared is not None else delta
    kept = torch.as_tensor(np.asarray(rec.kept_columns), dtype=torch.long,
                           device=dev)
    if kept.shape[0] == k_orig:
        return dk  # keep-in-place pruning / nothing pruned
    return torch.zeros((delta.shape[0], k_orig), dtype=delta.dtype,
                       device=dev).index_copy(1, kept, dk)


def _codebook_width(rec: CompressedDense) -> int:
    return (rec.shared.n_clusters if rec.shared is not None
            else int(rec.kept_columns.size))


def init_deltas(artifact) -> dict[str, torch.Tensor]:
    dev = tree_leaves(artifact.params)[0].device
    return {s.name: torch.zeros((rec.effective.shape[0], _codebook_width(rec)),
                                dtype=torch.float32, device=dev)
            for s, rec in recoverable_sites(artifact)}


def make_recover_step(artifact, loss_fn: Callable, *, lr: float = 1e-3,
                      optimizer=None):
    """Build ``(state0, step)`` for recovery fine-tuning.

    ``loss_fn(params, batch) -> scalar`` is the family's own training loss
    (e.g. ``models.mlp.mlp_loss``-style); it sees params with every
    recoverable site rebound to ``frozen + delta``.  Only the deltas train
    (``optimizer``: any optimizer of ``repro_torch.optim``, adamw by
    default).  ``step(state) -> (state, loss)`` updates the state's deltas
    in place; ``step.rebound_params(deltas)`` gives the rebound params for
    evaluation during or after recovery.
    """
    sites = recoverable_sites(artifact)
    base_params = artifact.params
    k_orig = {s.name: int(_site_weight_traced(base_params, s).shape[1])
              for s, _ in sites}
    opt = optimizer if optimizer is not None else adamw()
    deltas0 = init_deltas(artifact)
    state0 = RecoverState(deltas=deltas0, opt_state=opt.init(deltas0), step=0)

    def rebound(deltas):
        params = base_params
        for s, rec in sites:
            w = _site_weight_traced(params, s)
            d = _expand_delta(deltas[s.name], rec, k_orig[s.name])
            params = compress_adapters.rebind_site_traced(params, s, w + d)
        return params

    def step(state: RecoverState, batch) -> tuple[RecoverState, torch.Tensor]:
        names = list(state.deltas)
        leaves = [state.deltas[n].requires_grad_(True) for n in names]
        loss = loss_fn(rebound(state.deltas), batch)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        for d in leaves:
            d.requires_grad_(False)
        deltas, opt_state = opt.update(grads, state.opt_state, state.deltas, lr)
        return RecoverState(deltas=deltas, opt_state=opt_state,
                            step=state.step + 1), loss.detach()

    step.rebound_params = rebound  # for eval during/after recovery
    return state0, step


def _sparsify_to_budget(d: np.ndarray, max_adds: int, frac_bits: int
                        ) -> np.ndarray:
    """Zero small residual entries until the residual's CSD adds fit
    ``max_adds`` (coarse quantile search — the residual is a correction, not
    a reconstruction, so precision of the cut is not critical)."""
    if adds_csd_matrix(d, frac_bits) <= max_adds:
        return d
    mags = np.abs(d[d != 0.0])
    for q in (50.0, 75.0, 87.5, 93.75, 96.9, 98.4, 99.2, 99.6, 99.8):
        cut = np.percentile(mags, q)
        trial = np.where(np.abs(d) >= cut, d, 0.0)
        if adds_csd_matrix(trial, frac_bits) <= max_adds:
            return trial
    return np.zeros_like(d)


def _host_f64(d) -> np.ndarray:
    """A delta (tensor on any device, or array) as float64 numpy."""
    if isinstance(d, torch.Tensor):
        d = d.detach().to("cpu").numpy()
    return np.asarray(d, np.float64)


def write_back(artifact, deltas: dict[str, torch.Tensor], *,
               residual_frac: float = 0.15) -> dict:
    """Write trained residuals into every artifact surface (in place).

    The residual is sparsified so its shift-add cost stays below
    ``residual_frac`` of the unit's LCC adds, then applied identically to
    ``records[name].effective``, the packed decomposition (extra dense slice
    over the full codebook span), and the dense-effective ``params``; the
    report gains ``stage_adds['recover']`` per touched unit.  Returns a
    summary dict per unit.
    """
    rows = {lc.name: lc for lc in artifact.report.layers}
    summary: dict[str, dict] = {}
    for site, rec in recoverable_sites(artifact):
        d = _host_f64(deltas[site.name]) if site.name in deltas else None
        if d is None or not np.any(d):
            continue
        cfg = artifact.unit_config_for(site.name)
        lcc_adds = rec.decomposition.num_adds()
        budget = max(1, int(residual_frac * max(lcc_adds, 1)))
        d = _sparsify_to_budget(d, budget, cfg.frac_bits)
        r_adds = adds_csd_matrix(d, cfg.frac_bits)
        nnz = int(np.count_nonzero(d))
        if nnz == 0:
            summary[site.name] = {"nnz": 0, "recover_adds": 0}
            continue

        # records: effective is kept-column space
        dk = d[:, rec.shared.labels] if rec.shared is not None else d
        rec.effective = rec.effective + dk

        # packed: one extra dense slice spanning the whole codebook input; the
        # new object starts with no device copies (``_dev`` is not an init
        # field), so its first use uploads the residual too
        pk = artifact.packed.get(site.name)
        if pk is not None:
            extra = ((0, pk.in_dim), np.asarray(d, np.float32))
            artifact.packed[site.name] = replace(pk, dense=pk.dense + (extra,))

        # params: re-derive the dense-effective leaf from the updated record
        # (zero-expanded, exactly like api.compress_model built it) so params
        # and records stay bitwise-consistent after the single f64->f32 cast
        w = site.weight(artifact.params)
        full = np.zeros_like(w)
        full[:, rec.kept_columns] = rec.effective
        artifact.params = compress_adapters.rebind_site(
            artifact.params, site, full)

        row = rows.get(site.name)
        if row is not None:
            row.stage_adds["recover"] = int(row.stage_adds.get("lcc", 0)) + r_adds
            row.stage_bytes["recover"] = 6 * nnz  # int16 (r,c) + po2 code
            row.extra["recovered"] = True
        summary[site.name] = {"nnz": nnz, "recover_adds": int(r_adds),
                              "lcc_adds": int(lcc_adds)}
    return summary


def recover_artifact(artifact, loss_fn: Callable, batches, *,
                     lr: float = 1e-3, optimizer=None,
                     residual_frac: float = 0.15,
                     progress: Callable | None = None) -> dict:
    """Fine-tune an artifact's residuals over ``batches`` and write back.

    ``batches`` is any iterable of loss-fn batches (one optimizer step each).
    Returns {"losses": [...], "units": write_back summary}.  The artifact is
    updated in place; save it again to persist the recovered values.
    """
    state, step = make_recover_step(artifact, loss_fn, lr=lr,
                                    optimizer=optimizer)
    losses: list[float] = []
    for i, batch in enumerate(batches):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if progress is not None and (i % 20 == 0):
            progress(f"recover step {i}: loss {losses[-1]:.5f}")
    units = write_back(artifact, state.deltas, residual_frac=residual_frac)
    return {"losses": losses, "units": units}
