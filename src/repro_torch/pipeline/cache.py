"""Content-addressed store for slice/channel decomposition results.

Key = sha256(weight bytes + canonical knob JSON): re-runs and tied/shared
weights (identical matrices under the same plan) are free.  Counterpart of
``repro.pipeline.cache``, in memory only: the reference's durable store (one
msgpack file an entry, its array leaves in the checkpointer's crc32
envelope) comes with the artifact on disk and its decoder, ROADMAP A1b.  The
in-memory map holds the same plain trees, array leaves in the same
``{dtype, shape, data, crc}`` envelope, so a lookup hands back a fresh piece
equal to the one stored.
"""
from __future__ import annotations

import hashlib
import json
import zlib
from typing import Any

import numpy as np

from repro_torch.core.lcc import FSProgram, LCCChain, LCCDecomposition, LCCFactor

__all__ = ["SliceCache", "job_key", "piece_to_tree", "piece_from_tree"]

_SALT = b"lcc-job-v1"  # bump when decomposition semantics change


def job_key(mat: np.ndarray, knobs: dict) -> str:
    """Content address of one decomposition job: matrix bytes + knobs."""
    a = np.ascontiguousarray(np.asarray(mat, np.float64))
    h = hashlib.sha256(_SALT)
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    h.update(json.dumps(knobs, sort_keys=True, default=str).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# piece <-> plain tree (scalars + array envelopes, the checkpointer's layout)
# ---------------------------------------------------------------------------


def _pack_leaf(x) -> dict:
    a = np.ascontiguousarray(np.asarray(x))
    b = a.tobytes()
    return {"dtype": a.dtype.str, "shape": list(a.shape), "data": b,
            "crc": zlib.crc32(b)}


def _unpack_leaf(d) -> np.ndarray:
    if zlib.crc32(d["data"]) != d["crc"]:
        raise IOError("slice cache crc mismatch")
    return np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])


def piece_to_tree(piece) -> dict:
    if isinstance(piece, LCCChain):
        return {"kind": "fp", "in_dim": piece.in_dim,
                "factors": [{"idx": _pack_leaf(f.idx), "exp": _pack_leaf(f.exp),
                             "sign": _pack_leaf(f.sign), "in_dim": f.in_dim}
                            for f in piece.factors]}
    if isinstance(piece, FSProgram):
        return {"kind": "fs", "n_inputs": piece.n_inputs,
                "nodes": _pack_leaf(np.asarray(piece.nodes, np.int64).reshape(-1, 6)),
                "outputs": _pack_leaf(np.asarray(piece.outputs, np.int64))}
    if isinstance(piece, LCCDecomposition):
        return {"kind": "dec", "shape": list(piece.shape),
                "col_slices": [list(cs) for cs in piece.col_slices],
                "algorithm": piece.algorithm,
                "target_snr_db": piece.target_snr_db,
                "meta": {k: v for k, v in piece.meta.items()
                         if isinstance(v, (int, float, str, bool, type(None)))},
                "slices": [piece_to_tree(s) for s in piece.slices]}
    raise TypeError(f"cannot serialize {type(piece)}")


def piece_from_tree(tree: dict):
    kind = tree["kind"]
    if kind == "fp":
        return LCCChain(
            factors=[LCCFactor(idx=np.asarray(_unpack_leaf(f["idx"]), np.int32),
                               exp=np.asarray(_unpack_leaf(f["exp"]), np.int8),
                               sign=np.asarray(_unpack_leaf(f["sign"]), np.int8),
                               in_dim=int(f["in_dim"]))
                     for f in tree["factors"]],
            in_dim=int(tree["in_dim"]))
    if kind == "fs":
        return FSProgram(
            n_inputs=int(tree["n_inputs"]),
            nodes=np.asarray(_unpack_leaf(tree["nodes"]), np.int64).reshape(-1, 6),
            outputs=np.asarray(_unpack_leaf(tree["outputs"]), np.int64))
    if kind == "dec":
        dec = LCCDecomposition(
            shape=tuple(tree["shape"]),
            col_slices=[tuple(cs) for cs in tree["col_slices"]],
            slices=[piece_from_tree(s) for s in tree["slices"]],
            algorithm=tree["algorithm"],
            target_snr_db=float(tree["target_snr_db"]))
        dec.meta.update(tree.get("meta", {}))
        return dec
    raise ValueError(f"unknown cached piece kind {kind!r}")


class SliceCache:
    """In-memory cache keyed by :func:`job_key` (same-run dedup of tied
    weights and of allocator probes)."""

    def __init__(self):
        self.mem: dict[str, Any] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: str):
        if key in self.mem:
            self.hits += 1
            return piece_from_tree(self.mem[key])
        self.misses += 1
        return None

    def put(self, key: str, piece) -> None:
        self.mem[key] = piece_to_tree(piece)

    def __len__(self) -> int:
        return len(self.mem)
