"""Fault-tolerant checkpointing: msgpack + crc32, async writer, auto-resume
(counterpart of ``repro.checkpoint.checkpointer``, the same files byte for
byte).

Layout:  <dir>/step_<N>/shard_<proc>.msgpack  +  <dir>/step_<N>/DONE
A checkpoint is valid iff DONE exists and every leaf's crc32 verifies; the
writer publishes DONE last and renames the step into place, so a crash
mid-write can never be mistaken for a valid checkpoint.  Saves run blocking
or on a background thread (leaves are copied to the host first, so training
may go on updating its tensors in place).  ``restore_latest`` walks back
until it finds an intact step: a corrupted or partial checkpoint is skipped
with a printed warning, as in the reference.

A tree is nested dicts (keys in sorted order), lists and tuples (by index)
and dataclasses (a field ``f`` named ``.f``, as JAX names a registered
dataclass's fields); ``None`` gives no leaf.  Leaves are tensors (any
device), numpy arrays or Python scalars, each stored as ``{dtype, shape,
data, crc}``: a bfloat16 leaf as ``"bfloat16"`` over its 16-bit pattern.
Reading maps the shard read-only: a leaf comes back as a numpy array viewing
the map (read-only, possibly unaligned), a bfloat16 leaf as a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import mmap
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import msgpack_codec

__all__ = ["Checkpointer", "read_payload", "unpack_payload"]


def _children(node):
    """``[(key, child)]`` of an inner node in flatten order; None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        # a field marked static (a sharded TrainState's spec tree) holds
        # no leaves
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)
                if not f.metadata.get("static")]
    return None


def _flatten(tree) -> dict:
    """``{"a/0/.f": leaf}`` in JAX's ``tree_flatten_with_path`` order."""
    out = {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out["/".join(path)] = node
            return
        for k, v in kids:
            walk(v, path + [k])

    walk(tree, [])
    return out


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like) if not f.metadata.get("static")})
    return next(leaves)


def _host_copy(x):
    """A copy of a leaf on the host: a CPU tensor, else a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _leaf_array(x) -> tuple[str, np.ndarray]:
    """(dtype string, contiguous host array) of a leaf: a bfloat16 leaf as
    ``"bfloat16"`` over its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(x))
        if a.dtype.kind == "V" and a.dtype.name == "bfloat16":  # ml_dtypes'
            return "bfloat16", a.view(np.uint16)
    return a.dtype.str, a


_PARALLEL = 1 << 20  # leaves this large get their crc32 on the thread pool


def _crcs(bufs: list) -> list[int]:
    """crc32 of each buffer; the large ones on a thread pool (zlib releases
    the interpreter lock while it sums)."""
    out = [0] * len(bufs)
    big = []
    for i, b in enumerate(bufs):
        if memoryview(b).nbytes >= _PARALLEL:
            big.append(i)
        else:
            out[i] = zlib.crc32(b)
    if big:
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            for i, c in zip(big, ex.map(lambda i: zlib.crc32(bufs[i]), big)):
                out[i] = c
    return out


def _pack_leaves(leaves: list) -> list[dict]:
    """Leaf envelopes ``{dtype, shape, data, crc}`` (``data``: the host
    array itself, written out by the encoder)."""
    arrays = [_leaf_array(x) for x in leaves]
    # an empty leaf (an FS program without nodes: [0, 6]) has no bytes to
    # sum, and a memoryview with a zero in its shape cannot be cast
    crcs = _crcs([memoryview(a).cast("B") if a.size else b"" for _, a in arrays])
    return [{"dtype": dt, "shape": list(a.shape), "data": a, "crc": c}
            for (dt, a), c in zip(arrays, crcs)]


def _pack_leaf(x) -> dict:
    return _pack_leaves([x])[0]


def _unpack_leaves(envelopes: list, names=None) -> list:
    """Envelopes -> numpy arrays viewing their data (bfloat16: CPU tensors),
    every crc32 checked once; ``IOError`` naming the leaf on a mismatch."""
    crcs = _crcs([d["data"] for d in envelopes])
    out = []
    for i, (d, c) in enumerate(zip(envelopes, crcs)):
        if c != d["crc"]:
            what = f" of leaf {names[i]!r}" if names is not None else ""
            raise IOError(f"checkpoint crc mismatch{what}")
        if d["dtype"] == "bfloat16":
            bits = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
            out.append(torch.from_numpy(bits.copy()).view(torch.bfloat16))
        else:
            out.append(np.frombuffer(d["data"], np.dtype(d["dtype"]))
                       .reshape(d["shape"]))
    return out


def _unpack_leaf(d):
    """A leaf envelope -> numpy array viewing its data (bfloat16: a CPU
    tensor); ``IOError`` when the crc32 does not match."""
    return _unpack_leaves([d])[0]


def unpack_payload(payload: dict) -> dict:
    """``{name: envelope}`` -> ``{name: leaf}``, every crc checked."""
    names = list(payload)
    return dict(zip(names, _unpack_leaves([payload[k] for k in names], names)))


def read_payload(path: str):
    """The decoded shard at ``path``, its bins viewing a read-only map of
    the file (the map lives as long as any view of it)."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return msgpack_codec.unpackb(mm)


def _like(leaf, like, name: str):
    """``leaf`` on a tensor ``like``'s device and in its dtype; any other
    leaf as it was read."""
    if not isinstance(like, torch.Tensor):
        return leaf
    if tuple(leaf.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {name!r} has shape "
                         f"{tuple(leaf.shape)}, the tree restored into has "
                         f"{tuple(like.shape)}")
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device=like.device, dtype=like.dtype)
    from repro_torch.kernels.dispatch import upload
    return upload(leaf, like.device).to(like.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.proc = process_index
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Write ``tree`` as step ``step``.  Every leaf reaches the host
        before this returns (non-blocking: as a copy, so the caller may go on
        updating its tensors); the write itself runs on a thread unless
        ``blocking``.  An error of the writer thread is raised by the next
        ``wait`` or ``save``."""
        if blocking:
            self.wait()
            self._write(step, _flatten(tree))
            return
        self.wait()  # one in-flight save at a time
        flat = {k: _host_copy(v) for k, v in _flatten(tree).items()}
        self._thread = threading.Thread(target=self._write_guarded,
                                        args=(step, flat), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, step: int, flat: dict) -> None:
        try:
            self._write(step, flat)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def _write(self, step: int, flat: dict) -> None:
        d = os.path.join(self.dir, f"step_{step:010d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        payload = dict(zip(flat, _pack_leaves(list(flat.values()))))
        with open(os.path.join(tmp, f"shard_{self.proc}.msgpack"), "wb") as f:
            msgpack_codec.pack(payload, f)
        open(os.path.join(tmp, "DONE"), "w").close()
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for n in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", n)
            if m and os.path.exists(os.path.join(self.dir, n, "DONE")):
                out.append(int(m.group(1)))
        return sorted(out)

    def shard_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}",
                            f"shard_{self.proc}.msgpack")

    def restore_flat(self, step: int) -> dict:
        """Raw ``{flat_name: array}`` payload of one step, every leaf
        crc-verified.  Used by consumers (e.g. ``core.artifact``) whose tree
        structure is recorded in the payload itself rather than supplied as a
        like-tree."""
        return unpack_payload(read_payload(self.shard_path(step)))

    def restore(self, step: int, like_tree):
        """Step ``step`` in ``like_tree``'s structure: where the like-leaf
        is a tensor, on its device and in its dtype (a copy of its own);
        elsewhere as ``restore_flat`` reads it."""
        payload = read_payload(self.shard_path(step))
        like = _flatten(like_tree)
        missing = [name for name in like if name not in payload]
        if missing:
            raise KeyError(f"checkpoint missing leaf {missing[0]!r}")
        got = _unpack_leaves([payload[name] for name in like], list(like))
        leaves = [_like(leaf, lk, name)
                  for leaf, (name, lk) in zip(got, like.items())]
        return _rebuild(like_tree, iter(leaves))

    def restore_latest(self, like_tree):
        """(step, tree) from the newest *intact* checkpoint; (None, None) if none."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like_tree)
            except Exception as e:  # corrupted shard: fall back to previous
                print(f"[checkpoint] step {step} unreadable ({e}); trying older")
        return None, None
