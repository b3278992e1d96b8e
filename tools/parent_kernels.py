#!/usr/bin/env python3
"""K3's region preparation and K7's norm of another checkout (the parent
commit) against this one's, on a GPU, in one process.

    git archive HEAD~1 | tar -x -C _parent      # any checkout of the parent
    python3 tools/parent_kernels.py --root _parent

Builds the kernels of ``--root`` with that checkout's own build module (into
its own ``build/``) beside this checkout's.  At every region of
``chip_smoke.py --only prep`` (``chip_smoke.region_preps``, the same members
and inputs) it prepares the region the way the other checkout's per-region
route did — per member a float32 copy of the activation, the kept-column
``index_select``, its ``repro_cluster_segment_sum`` kernel on a weight-shared
member, then one ``torch.cat`` — and through this tree's one region-prep
launch; at the olmo-1b and mixtral-8x22b plan serves' norm shapes both
trees' ``repro_step_norm`` (the other with its own arguments) and
``F.layer_norm`` / ``F.rms_norm``.  Each result is held against this tree's
plain version (the region bit for bit on dyadic input; the norm within
``chip_smoke.SUM_TOL``), then timed as ``chip_smoke.py`` times (CUDA events,
L2 flushed, median of 7) in turns: other, this, this, other.  One JSON
object a case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)
from repro_torch.kernels.layer_plan import (  # noqa: E402
    step_norm, step_norm_plain)
from repro_torch.kernels.shared_matmul import (  # noqa: E402
    csr_from_labels, region_layout, region_prep_plain)


def other_library(root: Path):
    """The other checkout's kernel library, built by its own build module."""
    spec = importlib.util.spec_from_file_location(
        "other_build", root / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def other_region(lib, prep, dev):
    """A callable preparing ``prep``'s region as the other checkout's
    per-region route did, through its ``repro_cluster_segment_sum``."""
    tables = []
    for kept, labels, c in prep.members:
        csr = (None if labels is None else
               tuple(t.to(dev) for t in csr_from_labels(labels, c)))
        tables.append((torch.from_numpy(kept).to(dev), csr, c))

    def run(xs):
        views, _ = region_layout(xs, prep.n_members)
        parts = []
        for (kept, csr, c), x in zip(tables, views):
            xg = x.to(torch.float32).index_select(0, kept)
            if csr is not None:
                out = torch.empty((c, xg.shape[1]), device=dev)
                code = lib.repro_cluster_segment_sum(
                    csr[0].data_ptr(), csr[1].data_ptr(), xg.data_ptr(),
                    out.data_ptr(), c, xg.shape[1],
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"repro_cluster_segment_sum: CUDA error {code}")
                xg = out
            parts.append(xg)
        return torch.cat(parts)
    return run


def other_norm(lib, x, w, norm):
    d, b = x.shape
    out = torch.empty_like(x)
    mode, eps = (0, 1e-6) if norm == "rms" else (1, 1e-5)
    code = lib.repro_step_norm(x.data_ptr(), None if w is None else w.data_ptr(),
                               out.data_ptr(), d, b, mode, eps,
                               torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"repro_step_norm: CUDA error {code}")
    return out


def in_turns(timer, other, this):
    """Times in the order other, this, this, other."""
    o1, t1, t2, o2 = timer(other), timer(this), timer(this), timer(other)
    return [o1, o2], [t1, t2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, required=True,
                    help="the other checkout (its src/ and csrc/ are used)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("parent_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    lib = other_library(args.root.resolve())
    timer = cs.Timer(dev)
    for arch in cs.PREP_ARCHS:
        cfg = cs.get_arch(arch)
        cases = [(c, torch.bfloat16) for c in cs.region_preps(cfg)]
        if cfg.mla is not None:  # the K9 serve's per-region sites, float32
            cases += [(c, torch.float32) for c in cs.region_preps(cfg)
                      if not c[5][0].startswith(cs.ROUTED)]
        for (label, prep, k, batch, stacked, _), dtype in cases:
            rng = np.random.default_rng(cs.zlib.crc32(label.encode()))
            xs = cs.prep_input(prep.n_members, k, batch, dtype, stacked, rng,
                               dev)
            other = other_region(lib, prep, dev)
            want = region_prep_plain(prep, xs)
            for tree, fn in (("other", other), ("this", prep)):
                got = fn(xs)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    cs.fail(f"{tree} {label}: differs from the plain version")
            other_ms, this_ms = in_turns(timer, lambda: other(xs),
                                         lambda: prep(xs))
            cs.emit(dict(kernel="region_prep", shape=label,
                         dtype=str(dtype).removeprefix("torch."),
                         members=prep.n_members, other_ms=other_ms,
                         this_ms=this_ms,
                         bound_ms=cs.prep_bound(
                             prep, stacked, batch,
                             torch.empty((), dtype=dtype).element_size())[0]))
    for arch in ("olmo-1b", "mixtral-8x22b"):
        cfg = cs.get_arch(arch)
        torch.manual_seed(cs.zlib.crc32(arch.encode()))
        d, b = cfg.d_model, cs.BATCH
        x = torch.randn((d, b), device=dev)
        xt = x.T.contiguous()
        rms = cfg.norm == "rms"
        w = 1.0 + 0.1 * torch.randn(d, device=dev) if rms else None
        eps = 1e-6 if rms else 1e-5
        want = step_norm_plain(x, w, cfg.norm)
        errs = {}
        for tree, fn in (("other", lambda: other_norm(lib, x, w, cfg.norm)),
                         ("this", lambda: step_norm(x, w, cfg.norm))):
            got = fn()
            torch.cuda.synchronize()
            errs[tree] = cs.check_close(f"{tree} {arch} norm", got, want,
                                        cs.SUM_TOL)
        other_ms, this_ms = in_turns(
            timer, lambda: other_norm(lib, x, w, cfg.norm),
            lambda: step_norm(x, w, cfg.norm))
        library_ms = timer(lambda: F.rms_norm(xt, (d,), w, eps) if rms
                           else F.layer_norm(xt, (d,), eps=eps))
        cs.emit(dict(kernel="step_norm", shape=f"{arch} norm [{d}, {b}]",
                     other_ms=other_ms, this_ms=this_ms, library_ms=library_ms,
                     max_abs_err=errs))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
