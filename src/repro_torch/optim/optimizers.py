"""Optimizers written out (counterpart of ``repro.optim.optimizers``).

SGD(+momentum), AdamW, and ProxSGD — the paper's training rule (eq. (7)): a
gradient step followed by the group-lasso proximal operator (eq. (8)) on the
regularized leaves.  The ``Optimizer(init, update)`` contract and the
reference's dtype sequence are kept: momentum and Adam moments are float32,
a parameter is updated as ``(p.float() - lr * m).to(p.dtype)``.

**Updates are in place.**  ``update(grads, state, params, lr)`` writes the
new values into the ``params`` and ``state`` tensors it is given (under
``torch.no_grad()``) and returns those same structures: at olmo-1b width a
functional update would hold a second copy of the parameters and of the
float32 state (2-5 GB).  The elementwise updates go layer by layer over a
stacked leaf, so their float32 temporaries stay one layer's size.
``torch.optim`` is not used: its SGD keeps the momentum in the parameter's
dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.group_lasso import group_prox_rows

__all__ = ["sgd", "adamw", "prox_sgd", "global_norm", "clip_by_global_norm",
           "step_decay", "cosine_warmup", "Optimizer", "GroupSpec",
           "spec_group_view", "spec_group_norms", "apply_spec_prox",
           "tree_map", "tree_leaves", "zip_leaves", "tree_get"]


@dataclass(frozen=True)
class GroupSpec:
    """One regularized leaf and its group layout (derived from the same
    compression adapters the compressor slices, see
    ``repro_torch.training.regularize.site_group_specs``).

    kind:
      ``in_rows``          stored [..., K, N] (the ``dense_init`` layout):
                           groups are the input neurons = rows of the leaf;
      ``in_cols``          stored [..., N, K] (the paper's y = W x layout):
                           groups are columns of the stored leaf;
      ``conv_in_channels`` conv kernel [N, K, O, O]: groups are input
                           channels (the eq. (11) FK/PK row stacking).
    """

    name: str
    path: tuple
    lam: float
    kind: str


# --------------------------------------------------------------- trees


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in key order of construction (dicts) and index order (lists)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _tree_items(tree, prefix=()):
    """(path, leaf) pairs, paths as key tuples."""
    if isinstance(tree, dict):
        return [it for k, v in tree.items() for it in _tree_items(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in _tree_items(v, prefix + (i,))]
    return [(prefix, tree)]


def zip_leaves(tree, *rest) -> list[tuple]:
    """Tuples of corresponding leaves, matched by key (not by order: a dict
    converted from the JAX package may list its keys in another order)."""
    out = []
    tree_map(lambda *xs: out.append(xs), tree, *rest)
    return out


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _layers(t: torch.Tensor):
    """A stacked leaf ([L, ...], three or more axes) layer by layer (views);
    a matrix or vector whole."""
    return t.unbind(0) if t.dim() > 2 else (t,)


# ------------------------------------------------------ group layouts


def spec_group_view(leaf: torch.Tensor, kind: str) -> torch.Tensor:
    """Reshape a leaf so groups are rows of a 2-D [G, M] view (a view of the
    leaf for ``in_rows``; a copy where the groups are not contiguous)."""
    if kind == "in_rows":
        return leaf.reshape(-1, leaf.shape[-1])
    if kind == "in_cols":
        swapped = leaf.transpose(-1, -2)
        return swapped.reshape(-1, swapped.shape[-1])
    if kind == "conv_in_channels":
        moved = leaf.movedim(1, 0)  # [K, N, O, O]
        return moved.reshape(moved.shape[0], -1)
    raise ValueError(f"unknown group kind {kind!r}")


def _spec_unview(a2: torch.Tensor, kind: str, shape: tuple) -> torch.Tensor:
    shape = tuple(shape)
    if kind == "in_rows":
        return a2.reshape(shape)
    if kind == "in_cols":
        swapped_shape = shape[:-2] + (shape[-1], shape[-2])
        return a2.reshape(swapped_shape).transpose(-1, -2)
    if kind == "conv_in_channels":
        moved = a2.reshape((shape[1], shape[0]) + shape[2:])
        return moved.movedim(0, 1)
    raise ValueError(f"unknown group kind {kind!r}")


def spec_group_norms(leaf: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-group l2 norms [G] in float32, in the order of
    :func:`spec_group_view`'s rows, without a float32 copy of the leaf (on
    a GPU the reduction converts bf16 as it reads)."""
    norm = torch.linalg.vector_norm
    if kind == "in_rows":
        return norm(leaf, dim=-1, dtype=torch.float32).reshape(-1)
    if kind == "in_cols":
        return norm(leaf, dim=-2, dtype=torch.float32).reshape(-1)
    if kind == "conv_in_channels":
        dims = (0,) + tuple(range(2, leaf.dim()))
        return norm(leaf, dim=dims, dtype=torch.float32)
    raise ValueError(f"unknown group kind {kind!r}")


def apply_spec_prox(leaf: torch.Tensor, kind: str, thresh,
                    use_kernel: bool = True, *, inplace: bool = False
                    ) -> torch.Tensor:
    """Block soft threshold on a leaf's groups.  ``use_kernel=True`` runs the
    fused ``kernels.group_prox`` (K5: the CUDA kernel for a CUDA leaf, its
    plain version for a CPU leaf); ``False`` runs ``group_prox_rows`` in the
    leaf's own dtype, as the reference's XLA path does.

    ``inplace=True`` writes the result into ``leaf`` and returns it: an
    ``in_rows`` view is contiguous and the kernel writes it where it lies; the
    other layouts go through a contiguous copy that is written back."""
    a2 = spec_group_view(leaf, kind)
    if not a2.is_contiguous():
        a2 = a2.contiguous()
    if use_kernel:
        from repro_torch.kernels.group_prox import group_prox

        out = group_prox(a2, thresh, out=a2 if inplace else None)
    else:
        out = group_prox_rows(a2, thresh)
    res = _spec_unview(out, kind, leaf.shape)
    if not inplace:
        return res
    if res.data_ptr() != leaf.data_ptr() or res.stride() != leaf.stride():
        leaf.copy_(res)
    return leaf


# ------------------------------------------------------------ optimizers


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params, lr) -> (params, state)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares; a
    device scalar (no host sync)."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32).square()
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))`` as
    ``(g.float() * scale).to(g.dtype)``, in place.  Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        for gl in _layers(g):
            gl.copy_(gl.to(torch.float32) * scale)
    return grads, norm


def _zeros_f32(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        for p, m, g in zip_leaves(params, state["mu"], grads):
            for pl, ml, gl in zip(_layers(p), _layers(m), _layers(g)):
                # the reference's (momentum * m + g.f32) and
                # (p.f32 - lr * m).to(p.dtype), rounding for rounding: g and p
                # are read as float32 in place (no converted copies), and
                # p + (-lr * m) is p - lr * m exactly
                ml.mul_(momentum).add_(gl)
                step = torch.mul(ml, -lr)
                pl.copy_(step.add_(pl))
        return params, state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["t"].add_(1)
        tf = state["t"].to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)
        for p, m, v, g in zip_leaves(params, state["m"], state["v"], grads):
            for pl, ml, vl, gl in zip(_layers(p), _layers(m), _layers(v),
                                      _layers(g)):
                g32 = gl.to(torch.float32)
                ml.mul_(b1).add_((1 - b1) * g32)
                vl.mul_(b2).add_((1 - b2) * torch.square(g32))
                step = lr * (ml / bc1) / (torch.sqrt(vl / bc2) + eps)
                p32 = pl.to(torch.float32)
                if weight_decay:
                    step = step + lr * weight_decay * p32
                pl.copy_(p32 - step)
        return params, state

    return Optimizer(init, update)


def prox_sgd(momentum: float = 0.9,
             prox_spec: dict[str, tuple[float, str]] | None = None,
             specs: tuple[GroupSpec, ...] | list[GroupSpec] = (),
             use_kernel: bool = True) -> Optimizer:
    """Paper eq. (7): SGD step then block soft threshold on regularized leaves.

    Two ways to name the regularized groups:

    * ``specs`` — structured :class:`GroupSpec` records (one per leaf, exact
      path + group layout), normally from
      ``repro_torch.training.regularize.site_group_specs``.  The prox runs
      through the fused ``kernels.group_prox`` (K5: one launch a spec on a
      CUDA leaf); ``use_kernel=False`` takes ``group_prox_rows`` instead.
    * ``prox_spec`` — the legacy substring form {path-substring: (lambda,
      mode)}, mode in {"columns", "rows"}, applied to 2-D leaves only (the
      path joined with "/"), through ``group_prox_rows``.

    Threshold = lr * lambda (the eq. (8) scaling) in both forms.
    """
    base = sgd(momentum)
    spec = prox_spec or {}
    specs = tuple(specs)

    @torch.no_grad()
    def update(grads, state, params, lr):
        params, state = base.update(grads, state, params, lr)
        for gs in specs:
            apply_spec_prox(tree_get(params, gs.path), gs.kind, lr * gs.lam,
                            use_kernel=use_kernel, inplace=True)
        if not spec:
            return params, state
        for path, leaf in _tree_items(params):
            name = "/".join(str(k) for k in path)
            for pat, (lam, mode) in spec.items():
                if pat in name and leaf.dim() == 2:
                    t = lr * lam
                    if mode == "columns":
                        leaf.copy_(group_prox_rows(leaf.T, t).T)
                    else:
                        leaf.copy_(group_prox_rows(leaf, t))
                    break
        return params, state

    return Optimizer(base.init, update)


def step_decay(base_lr: float, decay: float = 0.95, every: int = 10):
    """The paper's MLP schedule: x0.95 every 10 epochs."""
    def lr(epoch):
        return base_lr * decay ** (epoch // every)
    return lr


def cosine_warmup(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up, then a cosine down to ``floor * base_lr``; float32
    arithmetic as in the reference.  Returns a 0-d float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * base_lr + (1 - floor) * base_lr * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
