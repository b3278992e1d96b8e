"""ResNet with pre-activation blocks (He et al. 2016), the paper's large model
(ResNet-34 on TinyImageNet); counterpart of ``repro.models.resnet``.

NCHW / OIHW, ``F.conv2d`` with the reference's "SAME" padding (asymmetric
at stride 2, padded explicitly as ``lax.conv_general_dilated`` does);
BatchNorm is GroupNorm(1) (LayerNorm over C, H, W with the population
variance), as in the reference.  Parameters are the reference's pytree
leaf for leaf: ``stem`` [w0, in_ch, k, k], ``blocks`` a list of dicts
(``gn1``, ``conv1``, ``gn2``, ``conv2`` and ``proj`` [w, c_in, 1, 1] at a
change of width), ``head`` {``w`` [classes, c], ``b``}.  A block's stride is
derived from ``proj``'s shape, not stored.

``resnet34_config()`` is the paper model; ``resnet_small_config()`` the
reduced variant the CPU tests and the card's compress loop use.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.conv_reshape import same_pad_2d

from .layers import matvec_acts

__all__ = ["ResNetConfig", "resnet34_config", "resnet_small_config",
           "init_resnet", "resnet_forward", "resnet_loss", "conv_kernels",
           "conv_same"]


@dataclass(frozen=True)
class ResNetConfig:
    stages: tuple[int, ...] = (3, 4, 6, 3)  # ResNet-34
    widths: tuple[int, ...] = (64, 128, 256, 512)
    classes: int = 200
    in_ch: int = 3
    stem_kernel: int = 3
    dtype: str = "float32"


def resnet34_config(classes: int = 200) -> ResNetConfig:
    return ResNetConfig(classes=classes)


def resnet_small_config(classes: int = 10) -> ResNetConfig:
    return ResNetConfig(stages=(1, 1), widths=(16, 32), classes=classes)


def _conv_init(gen, n_out, n_in, k, dtype, device):
    fan = n_in * k * k
    w = torch.randn((n_out, n_in, k, k), generator=gen) * (2.0 / fan) ** 0.5
    return w.to(device=device, dtype=dtype)


def init_resnet(generator: torch.Generator, cfg: ResNetConfig, device="cuda"):
    """He-normal conv kernels, unit GroupNorm scales, a 0.01-scaled head,
    drawn from ``generator`` (a CPU ``torch.Generator``) in the reference's
    order: stem, each block's conv1, conv2 (and proj), the head.  The
    reference draws from ``jax.random``, so the same seed gives other
    weights there; a test hands both packages the same arrays instead."""
    dt = getattr(torch, cfg.dtype)
    p = {"stem": _conv_init(generator, cfg.widths[0], cfg.in_ch,
                            cfg.stem_kernel, dt, device),
         "blocks": [], "head": {}}
    c_in = cfg.widths[0]
    for si, (n_blocks, w) in enumerate(zip(cfg.stages, cfg.widths)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {"gn1": torch.ones((c_in,), dtype=dt, device=device),
                   "conv1": _conv_init(generator, w, c_in, 3, dt, device),
                   "gn2": torch.ones((w,), dtype=dt, device=device),
                   "conv2": _conv_init(generator, w, w, 3, dt, device)}
            if stride != 1 or c_in != w:
                blk["proj"] = _conv_init(generator, w, c_in, 1, dt, device)
            p["blocks"].append(blk)
            c_in = w
    head = torch.randn((cfg.classes, c_in), generator=generator) * 0.01
    p["head"] = {"w": head.to(device=device, dtype=dt),
                 "b": torch.zeros((cfg.classes,), dtype=dt, device=device)}
    return p


def _gn(x, w):
    """GroupNorm(1) over (C, H, W), scale per channel; the population
    variance, as ``jnp.var``."""
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    var = x.var(dim=(1, 2, 3), keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-5) * w[None, :, None, None]


def conv_same(x, k, stride: int = 1):
    """Cross-correlation with XLA's "SAME" padding: ``F.conv2d`` refuses
    ``padding="same"`` at stride 2, where XLA pads one more row and column
    at the end than at the start."""
    lo_h, hi_h = same_pad_2d(x.shape[2], k.shape[2], stride)
    lo_w, hi_w = same_pad_2d(x.shape[3], k.shape[3], stride)
    return F.conv2d(F.pad(x, (lo_w, hi_w, lo_h, hi_h)), k, stride=stride)


def block_stride(blk) -> int:
    """2 exactly at the stage transitions (a ``proj`` that changes the
    width), else 1: the stride is derived, so the params stay arrays."""
    return 2 if ("proj" in blk
                 and blk["proj"].shape[0] != blk["proj"].shape[1]) else 1


def resnet_forward(params, x, executor=None):
    """x [B, C, H, W] -> logits [B, classes].

    ``executor`` (compressed serving, duck-typed): a conv site with a record
    runs in the compressed domain (``executor.conv(name)``, the FK/PK
    conv-as-matmul path: every decomposed channel's chain in one grouped
    launch), the linear head through its own chain (``executor.matvec``);
    uncovered sites stay dense."""
    def conv(name, h, k, stride=1):
        fn = executor.conv(name) if executor is not None else None
        if fn is None:
            return conv_same(h, k, stride)
        return fn(h, stride=stride, padding="SAME")

    h = conv("stem", x, params["stem"])
    for i, blk in enumerate(params["blocks"]):
        stride = block_stride(blk)
        y = torch.relu(_gn(h, blk["gn1"]))
        sc = conv(f"block{i}.proj", y, blk["proj"], stride) if "proj" in blk else h
        y = conv(f"block{i}.conv1", y, blk["conv1"], stride)
        y = torch.relu(_gn(y, blk["gn2"]))
        y = conv(f"block{i}.conv2", y, blk["conv2"])
        h = sc + y
    h = torch.relu(h).mean(dim=(2, 3))
    head_fn = executor.matvec("head") if executor is not None else None
    if head_fn is not None:
        return matvec_acts(head_fn, h) + params["head"]["b"]
    return h @ params["head"]["w"].T + params["head"]["b"]


def resnet_loss(params, x, y):
    """Mean cross-entropy of the logits against labels ``y`` [B]."""
    logits = resnet_forward(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, y[:, None].long(), dim=-1)[:, 0]
    return (lse - gold).mean()


def conv_kernels(params) -> list[tuple[str, torch.Tensor]]:
    """The 3x3 conv kernels (the reference's compression targets), name ->
    [N, K, O, O]."""
    out = [("stem", params["stem"])]
    for i, blk in enumerate(params["blocks"]):
        out.append((f"block{i}.conv1", blk["conv1"]))
        out.append((f"block{i}.conv2", blk["conv2"]))
    return out
