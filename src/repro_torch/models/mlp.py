"""The paper's MLP (Sec. IV-A): one hidden layer of width 300, trained with
group-lasso regularization (counterpart of ``repro.models.mlp``).
:class:`MLPConfig` names the ``mlp`` family of the compression-adapter
registry; weights act as ``y = W x`` (stored [N, K])."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["MLPConfig", "init_mlp_numpy", "init_mlp", "mlp_forward",
           "mlp_forward_custom", "mlp_forward_compressed", "mlp_loss",
           "mlp_accuracy"]


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 300
    classes: int = 10
    family: str = "mlp"  # compression-adapter registry key


def init_mlp_numpy(seed: int, in_dim: int = 784, hidden: int = 300,
                   classes: int = 10) -> dict:
    """He-normal weights, zero biases, float32 numpy, from a numpy generator
    (``jax.random`` cannot be reproduced; a test hands the same arrays to
    both packages)."""
    rng = np.random.default_rng(seed)
    s1 = np.float32((2.0 / in_dim) ** 0.5)
    s2 = np.float32((2.0 / hidden) ** 0.5)
    return {
        "fc1": {"w": rng.standard_normal((hidden, in_dim), dtype=np.float32) * s1,
                "b": np.zeros((hidden,), np.float32)},
        "fc2": {"w": rng.standard_normal((classes, hidden), dtype=np.float32) * s2,
                "b": np.zeros((classes,), np.float32)},
    }


def init_mlp(seed: int, in_dim: int = 784, hidden: int = 300,
             classes: int = 10, dtype=torch.float32, device="cuda"):
    return {k: {n: torch.from_numpy(a).to(device=device, dtype=dtype)
                for n, a in layer.items()}
            for k, layer in init_mlp_numpy(seed, in_dim, hidden, classes).items()}


def mlp_forward(params, x):
    """x [B, in_dim] -> logits [B, classes]. Weights act as y = W x."""
    h = torch.relu(x @ params["fc1"]["w"].T + params["fc1"]["b"])
    return h @ params["fc2"]["w"].T + params["fc2"]["b"]


def mlp_forward_custom(params, x, fc1_matvec=None):
    """Forward with a replaceable first-layer matvec (x [B, in_dim] ->
    [B, hidden], batch-major like the dense path it replaces)."""
    if fc1_matvec is None:
        return mlp_forward(params, x)
    h = torch.relu(fc1_matvec(x) + params["fc1"]["b"])
    return h @ params["fc2"]["w"].T + params["fc2"]["b"]


def mlp_forward_compressed(params, packed_fc1, x):
    """Compressed-dense forward: fc1 runs as ONE fused whole-chain LCC launch
    (K1, ``lcc_chain_matmul``, on a CUDA tensor; its plain version on a CPU
    tensor).

    ``packed_fc1`` is ``repro_torch.kernels.ops.pack_decomposition`` of an
    LCC decomposition of fc1's whole weight (paper Sec. IV-A: the 784->300
    layer), so it takes all ``in_dim`` inputs: a record compressed with
    keep-in-place pruning (``prune_tol < 0``) and no weight sharing.  The
    kernel contract is features-major, so the batch is transposed around the
    fused call; fc2 stays dense (it is not the compression target).
    """
    from repro_torch.kernels import ops

    h = ops.apply_packed_decomposition(packed_fc1, x.T).T
    h = torch.relu(h + params["fc1"]["b"])
    return h @ params["fc2"]["w"].T + params["fc2"]["b"]


def mlp_loss(params, x, y):
    logits = mlp_forward(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return (lse - gold).mean()


def mlp_accuracy(params, x, y, fc1_matvec=None):
    logits = mlp_forward_custom(params, x, fc1_matvec)
    return (torch.argmax(logits, -1) == y).to(torch.float32).mean()
