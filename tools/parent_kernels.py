#!/usr/bin/env python3
"""Kernels of another checkout (the parent commit) against this one's, on a
GPU, in one process.

    git archive HEAD~1 | tar -x -C _parent      # any checkout of the parent
    python3 tools/parent_kernels.py --root _parent [--sections modes]

Builds the kernels of ``--root`` with that checkout's own build module (into
its own ``build/``) beside this checkout's, and compares them by section
(``--sections``, all by default):

* ``modes``: at the stage launches the plan routes make in a mode other
  than the plain ones (``chip_smoke.main_path_stages``: olmo-1b gate+up and
  deepseek-v2-lite-16b's K9 stage A, gated; mixtral-8x22b's experts'
  gates+ups, gathered and gated, and its expert downs, combining, for 8
  tokens with a dropped choice and empty slots), the other checkout's
  launches — its ``repro_moe_dispatch`` where this tree gathers, then its
  ``repro_stage_matmul`` in the output mode (its signature before the
  gathered input) — against this tree's one launch in the modes, held
  equal bit for bit; beside them the stage alone (this tree, plain modes)
  and, where it gathers, this tree's stage in the output mode alone on the
  dispatched input;
* ``prep``: at every region of ``chip_smoke.py --only prep``
  (``chip_smoke.region_preps``, the same members and inputs) the region
  prepared the way the other checkout's per-region route did — per member
  a float32 copy of the activation, the kept-column ``index_select``, its
  ``repro_cluster_segment_sum`` kernel on a weight-shared member, then one
  ``torch.cat`` — and through this tree's one region-prep launch, held to
  this tree's plain version bit for bit on dyadic input;
* ``norm``: at the olmo-1b and mixtral-8x22b plan serves' norm shapes both
  trees' ``repro_step_norm`` (the other with its own arguments) and
  ``F.layer_norm`` / ``F.rms_norm``, within ``chip_smoke.SUM_TOL``.

Everything is timed as ``chip_smoke.py`` times (CUDA events, L2 flushed,
median of 7) in turns: other, this, this, other.  One JSON object a case,
then the card's name and power limit.
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
    device_stage, stage_args, stage_matmul, step_norm, step_norm_plain)
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


def other_pair(lib, ps, b, kw, sm, src=None):
    """A callable running stage ``ps`` (layer 0) at ``b`` columns in the
    modes of ``kw`` through the other checkout: its ``repro_moe_dispatch``
    into a dense input where ``kw`` gathers (else ``src``), then its
    ``repro_stage_matmul`` in the output mode (its signature before the
    gathered input)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    ds = device_stage(ps, dev)
    plan = ds.launch(b, 0, sm)
    n_exp = top_k = tokens = 0
    cx = (None, None, None)
    if kw.get("gated"):
        mode, shape = 1, (ps.out_dim // 2, b)
    elif "combine" in kw:
        x, slot, _ = kw["combine"]
        mode, shape, cx = 2, tuple(x.shape), tuple(t.data_ptr()
                                                   for t in kw["combine"])
        n_exp, tokens, top_k = ps.out_dim // x.shape[0], x.shape[1], slot.shape[1]
    else:
        mode, shape = 0, (ps.out_dim, b)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        x = src
        if "gather" in kw:
            h2, _, src_tok = kw["gather"]
            x = torch.empty((ps.d_src, b), device=dev)
            code = lib.repro_moe_dispatch(
                h2.data_ptr(), src_tok.data_ptr(), x.data_ptr(), h2.shape[0],
                h2.shape[1], ps.d_src // h2.shape[0], b, stream)
            if code:
                raise RuntimeError(f"repro_moe_dispatch: CUDA error {code}")
        out = torch.empty(shape, device=dev)
        ptrs, sizes, _scratch = stage_args(ds, x, 0, None, plan, out)
        code = lib.repro_stage_matmul(*ptrs, *cx, *sizes, mode, n_exp, top_k,
                                      b if mode == 2 else 0, tokens,
                                      plan.host_groups.ctypes.data,
                                      len(plan.groups), stream)
        if code:
            raise RuntimeError(f"repro_stage_matmul: CUDA error {code}")
        return out
    return run


def modes(lib, dev, timer) -> None:
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for arch, _, cases, _ in cs.main_path_stages(dev):
        cfg = cs.get_arch(arch)
        for label, name, ps, batch in cases:
            mode = cs.serve_mode(cfg, name)
            if mode is None:
                continue  # launched in the plain mode
            kw, key_mode = cs.mode_kwargs(ps, batch, mode, dev)
            src, xin = cs.stage_input(ps, kw, np.random.default_rng(71),
                                      batch, dev)
            other = other_pair(lib, ps, batch, kw, sm, src=xin)

            def this(ps=ps, xin=xin, kw=kw):
                return stage_matmul(ps, xin, layer=0, **kw)
            got_other, got_this = other(), this()
            torch.cuda.synchronize()
            if not torch.equal(got_other, got_this):
                cs.fail(f"{label}: the modes differ from the other "
                        "checkout's launches by "
                        f"{float((got_other - got_this).abs().max()):.3e}")
            other_ms, this_ms = in_turns(timer, other, this)
            extra = {}
            if "gather" in kw:  # the output mode alone, on the dense input
                out_kw = {k: v for k, v in kw.items() if k != "gather"}
                extra["output_mode_ms"] = timer(
                    lambda: stage_matmul(ps, src, layer=0, **out_kw))
            cs.emit(dict(kernel=cs.mode_row(key_mode), shape=label,
                         mode="+".join(m for m in key_mode if isinstance(m, str)),
                         other_pair_ms=other_ms, this_ms=this_ms,
                         stage_ms=timer(lambda ps=ps, src=src: stage_matmul(
                             ps, src, layer=0)),
                         bound_ms=cs.bound_of(*cs.mode_cost(
                             device_stage(ps, dev), 0, batch, kw))[0],
                         bitwise_equal=True, **extra))
            del other, src, xin
            torch.cuda.empty_cache()


def in_turns(timer, other, this):
    """Times in the order other, this, this, other."""
    o1, t1, t2, o2 = timer(other), timer(this), timer(this), timer(other)
    return [o1, o2], [t1, t2]


def regions(lib, dev, timer) -> None:
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


def norm(lib, dev, timer) -> None:
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


SECTIONS = {"modes": modes, "prep": regions, "norm": norm}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, required=True,
                    help="the other checkout (its src/ and csrc/ are used)")
    ap.add_argument("--sections", nargs="+", choices=tuple(SECTIONS),
                    default=list(SECTIONS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("parent_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = other_library(args.root.resolve())
    timer = cs.Timer(dev)
    for name in args.sections:
        SECTIONS[name](lib, dev, timer)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
