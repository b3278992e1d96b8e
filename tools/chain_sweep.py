#!/usr/bin/env python3
"""Sweep the launch geometry of the K1/K2 chain body on a GPU, and split its
time with diagnostic builds.

    python3 tools/chain_sweep.py                      # plan + geometry sweep
    python3 tools/chain_sweep.py --diagnose           # + diagnostic builds
    python3 tools/chain_sweep.py --shapes uk+uv,moe.gate

Shapes are ``chip_smoke.chain_cases``: the K1/K2 launches of the per-region
serves of ``ARCHS`` (the seven archs of the registry), members drawn by
``testing.seeded_decomposition`` at the fixture's (N, K); ``--shapes`` keeps
the labels that contain one of its words.  Every configuration launches the
group entry point of ``csrc/lcc_chain.cuh`` with an explicit geometry —
``(bb, threads, chunks, tile, stages)`` — and is held bit for bit against the
plain per-slice results summed in that geometry's order, then timed as
``chip_smoke.py`` times (CUDA events, L2 flushed, median of 7):

* ``plan``: ``plan_launch`` / ``launch_staging``, what the wrappers launch;
* the sweep: every batch width ``bb`` and thread count the body takes
  (blocks above 512 threads only at one column), slice chunks filling one
  wave of block slots or rounding up past it, and for the plan's ``bb`` and
  threads the widest staging tile at 2, 3 and 4 slots;
* ``--diagnose``: the plan's geometry on three builds of the body that are
  wrong on purpose, each removing one cost — ``conflict_free`` (the second
  term of a row gathers the row itself), ``no_term_reads`` (constant terms,
  the staged ones unread), ``no_staging`` (that, and no copies at all),
  ``copies_only`` (the copies and barriers, no row computed).
  Their differences split the time; their results are not checked.

One JSON object per configuration; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.lcc_chain_matmul import (  # noqa: E402
    MAX_SUMS, SM_SMEM, SMEM_LIMIT, _align16, _levels_plain,
    _slice_inputs_plain, launch_staging, plan_launch, slot_bytes)
from repro_torch.testing import seeded_decomposition  # noqa: E402

ARCHS = ("olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b", "qwen2.5-3b",
         "llama3.2-3b", "yi-9b", "qwen2-vl-7b")
ENTRY = "repro_lcc_group_matmul"
# diagnostic builds: (old, new) snippets of csrc/lcc_chain.cuh
_PAIR_TERMS = ("""        const int2 j0 = reinterpret_cast<const int2*>(s_idx)[r];
        const char2 e0 = reinterpret_cast<const char2*>(s_exp)[r];
        const char2 g0 = reinterpret_cast<const char2*>(s_sign)[r];
        int2 j1 = make_int2(0, 0);
        char2 e1 = make_char2(0, 0), g1 = make_char2(0, 0);
        if (two) {
          j1 = reinterpret_cast<const int2*>(s_idx)[r2];
          e1 = reinterpret_cast<const char2*>(s_exp)[r2];
          g1 = reinterpret_cast<const char2*>(s_sign)[r2];
        }""", """        const int2 j0 = make_int2(p ? r0 + r : 0, p ? r0 + r : 1);
        const char2 e0 = make_char2(-3, -4), g0 = make_char2(1, -1);
        const int2 j1 = make_int2(p ? r0 + r2 : 0, p ? r0 + r2 : 1);
        const char2 e1 = make_char2(-3, -4), g1 = make_char2(1, -1);""")
DIAGNOSTICS = {
    "conflict_free": [("""        term(g0.y, j0.y, e0.y, a0);
        term(g1.y, j1.y, e1.y, a1);""", """        term(g0.y, p ? r0 + r : j0.y, e0.y, a0);
        term(g1.y, p ? r0 + r2 : j1.y, e1.y, a1);""")],
    "no_term_reads": [_PAIR_TERMS],
    "no_staging": [_PAIR_TERMS, ("""      if (copier)
        stage_item(pf, ring + ((i + stages - 1) % stages) * sbytes, idx, exp,
                   sign, g, E, P, N, S, tile, tid - T, kCopyThreads);
""", "")],
    "copies_only": [("""    for (int r = copier ? rows : tid; r < rows; r += 2 * T) {""",
                     """    for (int r = rows; r < rows; r += 2 * T) {""")],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bind(path: Path):
    fn = getattr(ctypes.CDLL(str(path)), ENTRY)
    fn.argtypes = build._SIGNATURES[ENTRY]
    fn.restype = ctypes.c_int
    return fn


def diagnostic_builds(names) -> dict:
    """One library a diagnostic, built from the group entry point and an
    edited copy of the body (all nvcc processes started together)."""
    csrc = build.CSRC
    body = (csrc / "lcc_chain.cuh").read_text()
    procs = {}
    for name in names:
        text = body
        for old, new in DIAGNOSTICS[name]:
            if old not in text:
                raise SystemExit(f"chain_sweep: diagnostic {name} no longer "
                                 "matches csrc/lcc_chain.cuh")
            text = text.replace(old, new)
        d = build.build_dir() / "sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "lcc_chain.cuh").write_text(text)
        shutil.copy(csrc / "lcc_group_matmul.cu", d / "lcc_group_matmul.cu")
        cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / "lcc_group_matmul.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chain_sweep: nvcc failed for {name}:\n{out}")
        libs[name] = bind(d / "lib.so")
    return libs


def staging_at(n, s, bb, threads, stages, budget=SMEM_LIMIT):
    """The widest tile (whole rows a thread, or the factor) at ``stages``."""
    buffers = _align16(2 * n * bb * 4)
    rpt = -(-n // threads)
    for rows in range(rpt, 0, -1):
        tile = n if rows == rpt else rows * threads
        if buffers + stages * slot_bytes(tile, s) <= budget:
            return tile, stages, buffers + stages * slot_bytes(tile, s)
    return None


def chunking(e, blocks_other, slots, one_wave):
    want = slots // blocks_other if one_wave else -(-slots // blocks_other)
    spb = -(-e // min(e, max(1, want)))
    return -(-e // spb), spb


def sweep_configs(n, s, b, g, e, sm):
    """``(label, bb, threads, chunks, spb, tile, stages)`` of the sweep."""
    out, seen = [], set()
    for bb in (8, 4, 2, 1):
        if not (bb == 1 or bb < 2 * b):
            continue
        for threads in (960, 512, 256):
            threads = min(threads, -(-n // 32) * 32)
            if ((threads > 512 and bb != 1) or (bb, threads) in seen
                    or -(-n // threads) * bb > MAX_SUMS):
                continue
            seen.add((bb, threads))
            st = staging_at(n, s, bb, threads, 2)
            if st is None:
                continue
            per_sm = 2 if 2 * (st[2] + 1024) <= SM_SMEM and threads <= 256 else 1
            waves = {chunking(e, g * -(-b // bb), sm * per_sm, one_wave):
                     "one wave" if one_wave else "rounded up"
                     for one_wave in (False, True)}
            for (chunks, spb), how in waves.items():
                out.append((f"bb={bb} T={threads} {how}", bb, threads, chunks,
                            spb, st[0], st[1]))
    bb, threads, chunks, spb = plan_launch(n, b, g, e, sm, s)
    budget = SM_SMEM // 2 - 1024 if threads == 256 else SMEM_LIMIT
    for stages in (2, 3, 4):
        st = staging_at(n, s, bb, threads, stages, budget)
        if st is not None:
            out.append((f"plan geometry, {stages} slots", bb, threads, chunks,
                        spb, st[0], stages))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None,
                    help="comma-separated words; keep labels containing one")
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chain_sweep: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    libs = {"body": getattr(build.load(), ENTRY)}
    if args.diagnose:
        libs.update(diagnostic_builds(DIAGNOSTICS))
    emit(dict(phase="build", card=smi, seconds=time.perf_counter() - t0))
    words = args.shapes.split(",") if args.shapes else None
    timer = cs.Timer(dev)
    pool = ThreadPoolExecutor(8)
    for ai, arch in enumerate(ARCHS):
        for ci, (label, _, batch, members) in enumerate(cs.chain_cases(arch)):
            if words and not any(w in label for w in words):
                continue
            packed = list(pool.map(
                lambda j: ops.pack_decomposition(seeded_decomposition(
                    *members[j], np.random.default_rng((50, ai, ci, j)))),
                range(len(members))))
            ds = ops.pack_group(packed).on(dev)
            rng = np.random.default_rng((51, ai, ci))
            x = torch.cat([cs.dyadic(rng, (m.in_dim, batch), dev)
                           for m in packed])
            g, e, p, n, s = ds.idx.shape
            per = _levels_plain(ds.idx, ds.exp, ds.sign, _slice_inputs_plain(
                x, ds.slice_c0, ds.slice_w, max(n, int(ds.slice_w.max()))))
            live = (ds.chain_len > 0).cpu().numpy()
            bb, threads, chunks, spb = plan_launch(n, batch, g, e, sm, s)
            tile, stages, _ = launch_staging(n, s, bb, threads)
            configs = [("body", "plan", bb, threads, chunks, spb, tile, stages)]
            configs += [(v, "plan", bb, threads, chunks, spb, tile, stages)
                        for v in libs if v != "body"]
            if not args.no_sweep:
                configs += [("body", *c) for c in sweep_configs(
                    n, s, batch, g, e, sm)]
            for v, name, bb, threads, chunks, spb, tile, stages in configs:
                partial = torch.empty((g, chunks, n, batch), device=dev)
                out = torch.empty((g, n, batch), device=dev)
                ptrs = [t.data_ptr() for t in (
                    ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w,
                    ds.chain_len, partial, out)]
                dims = [g, e, p, n, s, batch, chunks, spb, bb, threads, tile,
                        stages]

                def call(fn=libs[v], ptrs=ptrs, dims=dims):
                    code = fn(*ptrs, *dims,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"launch refused: CUDA error {code}")
                row = dict(shape=label, build=v, config=name, bb=bb,
                           threads=threads, chunks=chunks, tile=tile,
                           stages=stages, blocks=g * -(-batch // bb) * chunks)
                call()
                torch.cuda.synchronize()
                if v == "body":
                    want = torch.zeros((g, n, batch), device=dev)
                    for gi in range(g):
                        for c in range(chunks):
                            sl = [ei for ei in range(c * spb, min(e, (c + 1) * spb))
                                  if live[gi, ei]]
                            if sl:
                                acc = per[gi, sl[0]]
                                for ei in sl[1:]:
                                    acc = acc + per[gi, ei]
                                want[gi] += acc
                    if not torch.equal(out, want):
                        raise SystemExit(f"chain_sweep: {label} {name}: differs "
                                         "from the plain version in its order")
                row["ms"] = timer(call)
                emit(row)
            del per, ds, packed, x
            torch.cuda.empty_cache()
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
