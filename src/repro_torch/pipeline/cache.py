"""Content-addressed store for slice/channel decomposition results.

Key = sha256(weight bytes + canonical knob JSON): re-runs, resumed runs and
tied/shared weights (identical matrices under the same plan) are free.  Each
entry is one msgpack file whose array leaves carry the checkpointer's crc32
envelope, written atomically (tmp + rename), so a SIGKILL mid-``put`` can
never publish a torn entry — the property the resume path relies on.  A
torn or corrupt entry reads as a miss and is overwritten.  Counterpart of
``repro.pipeline.cache``, the same files byte for byte; without a directory
the store is in memory only (same-run dedup of tied weights).  A lookup
hands back a fresh piece decoded from the stored bytes (its arrays are
read-only views of them).
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from repro_torch.checkpoint import msgpack_codec
from repro_torch.checkpoint.checkpointer import _pack_leaf, _unpack_leaf
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
# piece <-> plain tree (msgpack-able: scalars + _pack_leaf array envelopes)
# ---------------------------------------------------------------------------


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
    """Filesystem cache keyed by :func:`job_key`; ``None`` directory disables
    persistence but keeps an in-memory map (same-run dedup of tied weights)."""

    def __init__(self, directory: str | None = None):
        self.dir = directory
        self.mem: dict[str, bytes] = {}  # key -> the entry's msgpack bytes
        self.hits = 0
        self.misses = 0
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.msgpack")

    def get(self, key: str):
        if key in self.mem:
            self.hits += 1
            return piece_from_tree(msgpack_codec.unpackb(self.mem[key]))
        if self.dir is not None and os.path.exists(self._path(key)):
            try:
                with open(self._path(key), "rb") as f:
                    blob = f.read()
                piece = piece_from_tree(msgpack_codec.unpackb(blob))  # crc per leaf
            except (OSError, ValueError, KeyError, TypeError):
                self.misses += 1
                return None  # torn/corrupt entry: recompute and overwrite
            self.mem[key] = blob
            self.hits += 1
            return piece
        self.misses += 1
        return None

    def put(self, key: str, piece) -> None:
        blob = msgpack_codec.packb(piece_to_tree(piece))
        self.mem[key] = blob
        if self.dir is None:
            return
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)  # atomic publish

    def __len__(self) -> int:
        if self.dir is None:
            return len(self.mem)
        return sum(1 for n in os.listdir(self.dir) if n.endswith(".msgpack"))
