"""Elastic scaling and failure handling at the launcher level (counterpart
of ``repro.distributed.elastic``).

Synchronous SPMD cannot drop a participant mid-step; the recovery path is:
detect (heartbeat timeout / collective error) -> shrink or remap the mesh
-> reshard the latest state from a host copy -> continue.  This module
holds the mesh arithmetic and the resharding; ``launch/train.py
--elastic-demo`` drives it.

Straggler policy (launcher-side): persistent stragglers are
indistinguishable from slow failures under SPMD — the monitor treats a pod
whose heartbeat lags > ``straggler_factor`` x the fastest pod's pace as
failed and triggers the same remesh path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from .device_mesh import Mesh, mesh_over
from .placement import shard_tree

__all__ = ["MeshPlan", "plan_for_devices", "reshard_tree", "HeartbeatMonitor"]


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    def build(self, ranks=None) -> Mesh:
        """The mesh over the first ``prod(shape)`` of ``ranks`` (default:
        the whole world).  Every rank of the world calls it; the ranks left
        out get a mesh with no coordinates."""
        ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
        need = math.prod(self.shape)
        if len(ranks) < need:
            raise ValueError(f"need {need} devices, have {len(ranks)}")
        return mesh_over(ranks[:need], self.shape, self.axes)


def plan_for_devices(n_devices: int, *, model_parallel: int = 16,
                     multi_pod_threshold: int = 512) -> MeshPlan:
    """Largest mesh plan that fits the surviving device count.

    Keeps the model axis fixed (TP degree is an arch property); absorbs losses
    on the data/pod axes — the axes gradient-descent parallelism tolerates.
    """
    mp = min(model_parallel, n_devices)
    rest = n_devices // mp
    if n_devices >= multi_pod_threshold and rest % 2 == 0:
        return MeshPlan((2, rest // 2, mp), ("pod", "data", "model"))
    return MeshPlan((rest, mp), ("data", "model"))


def reshard_tree(tree, mesh: Mesh, pspecs, device=None):
    """A host (numpy / CPU tensor) tree or a whole one -> this rank's chunks
    of it on ``mesh`` (on the mesh's device unless ``device``).  The value
    tree drives the walk, so the spec leaves stay whole."""
    return shard_tree(tree, pspecs, mesh,
                      mesh.device if device is None else device)


class HeartbeatMonitor:
    """Tracks per-pod step-completion timestamps; flags failures/stragglers."""

    def __init__(self, n_pods: int, timeout_s: float = 300.0,
                 straggler_factor: float = 3.0):
        self.n_pods = n_pods
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.last_beat = {p: 0.0 for p in range(n_pods)}
        self.durations: dict[int, list[float]] = {p: [] for p in range(n_pods)}

    def beat(self, pod: int, t: float) -> None:
        prev = self.last_beat[pod]
        if prev:
            self.durations[pod].append(t - prev)
        self.last_beat[pod] = t

    def failed_pods(self, now: float) -> list[int]:
        out = [p for p, t in self.last_beat.items() if t and now - t > self.timeout_s]
        means = [np.mean(d[-5:]) for d in self.durations.values() if d]
        # reference pace = fastest pod (robust even when half the pods straggle)
        ref = min(means) if means else 0.0
        if ref > 0:
            for p, d in self.durations.items():
                if d and np.mean(d[-5:]) > self.straggler_factor * ref and p not in out:
                    out.append(p)  # persistent straggler == slow failure
        return sorted(out)

    def surviving_device_count(self, total: int, failed: list[int]) -> int:
        per_pod = total // self.n_pods
        return total - per_pod * len(failed)
