"""Kernel dispatch policy and launch accounting.

There is no interpreter here.  The policy is decided by where the tensor
lies: a CUDA tensor launches the hand-written kernel or raises; a CPU tensor
takes the kernel's plain PyTorch version (same arithmetic, step by step).  No
wrapper falls back from a failed build or launch to the plain version.

Launch accounting is a run-time count of real launches: every kernel wrapper
calls :func:`record_launch` at the point where it enqueues its kernel on the
device, and nowhere else — the plain versions never count.  One count is one
call of a kernel's C entry point (the chain kernels enqueue their fixed-order
reduction pass inside that same call).  A wrapper also passes the dimensions
it launched at, so a run can be asked which shapes it really went through.
Every launch also increments ``kernel_launches_total`` in the process-wide
:mod:`repro_torch.obs` registry (the reference's ``pallas_launches_total``,
which counts at trace time).

Host arrays reach a device through :func:`upload`, which also takes the
read-only, possibly unaligned views of a mapped artifact.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["upload", "on_device", "check_tensor", "check_launch",
           "record_launch", "launch_count", "launch_counts",
           "launch_counts_by_shape", "reset_launch_count"]

_launch_counts: dict[str, int] = {}
_shape_counts: dict[tuple[str, tuple], int] = {}
_launch_metric = None  # lazily resolved obs counter (process-global registry)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``.  A writable array goes through
    ``torch.from_numpy`` (on the CPU the tensor shares its memory); a
    read-only one (a view of a mapped artifact, possibly unaligned) is
    always copied, on the CPU too, so that no tensor aliases the map and
    nothing can write into it."""
    if a.flags.writeable:
        return torch.from_numpy(a).to(device)
    with warnings.catch_warnings():
        # torch warns that it cannot mark the tensor read-only: the copy
        # below only reads it
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(a)
    return src.to(device, copy=True)


def on_device(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the CUDA kernel (it lies on a GPU)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"no kernel and no plain version for device {t.device}")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of ``dtype``
    and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(code: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch refused (CUDA error {code})")


def record_launch(name: str, n: int = 1, *, shape: tuple | None = None) -> None:
    """Count ``n`` launches of kernel ``name``, launched at dimensions
    ``shape``; also published as the live ``kernel_launches_total`` counter
    of the process-global :mod:`repro_torch.obs` registry (resolved lazily,
    so importing this module sets up no telemetry)."""
    global _launch_metric
    _launch_counts[name] = _launch_counts.get(name, 0) + n
    if _launch_metric is None:
        from repro_torch.obs import get_global
        _launch_metric = get_global().counter(
            "kernel_launches_total",
            "kernel launches recorded at run time, process-wide")
    _launch_metric.inc(n)
    if shape is not None:
        key = (name, tuple(shape))
        _shape_counts[key] = _shape_counts.get(key, 0) + n


def launch_count(name: str | None = None) -> int:
    """Launches since import or the last reset — of one kernel, or of all."""
    if name is not None:
        return _launch_counts.get(name, 0)
    return sum(_launch_counts.values())


def launch_counts() -> dict[str, int]:
    """Per-kernel launch counts since import or the last reset."""
    return dict(_launch_counts)


def launch_counts_by_shape() -> dict[tuple[str, tuple], int]:
    """Launch counts per ``(kernel, dimensions)`` since import or the last
    reset.  Dimensions: ``(E, P, N, S, K, B)`` for ``lcc_chain_matmul``,
    ``(G, E, P, N, S, K, B)`` for ``lcc_group_matmul`` (K = rows of the
    concatenated input), ``(G, K, R, B, input bytes an element)`` for
    ``region_prep``, ``(d, B)`` for ``step_norm``, ``(G, M)`` for
    ``group_prox``, ``(N, S, K, B)`` for ``lcc_factor_matmul``,
    ``(P, R, S, K_alloc, D_src, O, J, B, layers)`` for ``stage_matmul``,
    followed by ``("gated",)`` or ``("combine", T, k)`` for a launch in
    one of its epilogue's output modes."""
    return dict(_shape_counts)


def reset_launch_count() -> None:
    _launch_counts.clear()
    _shape_counts.clear()
