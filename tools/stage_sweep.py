#!/usr/bin/env python3
"""Sweep the launch geometry of the K6 stage kernel on a GPU, and split its
time with diagnostic builds.

    python3 tools/stage_sweep.py                      # plan + geometry sweep
    python3 tools/stage_sweep.py --diagnose           # + diagnostic builds
    python3 tools/stage_sweep.py --shapes eg,qkv --no-sweep --diagnose

Shapes are ``chip_smoke.main_path_stages``: the ten K6 launches of the
olmo-1b, mixtral-8x22b and deepseek-v2-lite-16b float32 plan routes, layer
0 of one-layer seeded artifacts at full width; ``--shapes`` keeps the
labels that contain one of its words.  Every configuration launches the
entry point of ``csrc/stage_matmul.cu`` (prep, chain kernel, epilogue) with
an explicit geometry — ``(bb, threads, tile, stages, chunks)`` — and is held
bit for bit against ``chip_smoke.ordered_stage_plain`` in that geometry's
chunk order, then timed as ``chip_smoke.py`` times (CUDA events, L2 flushed,
median of 7):

* ``plan``: ``plan_stage`` / ``plan_units``, what the wrapper launches
  (each site at its own geometry), and where the sites' geometries differ,
  every site at the longest slice's;
* the sweep: every batch width ``bb`` and row-thread count the kernel takes
  (above 512 threads only at one column), chunks filling one wave of block
  slots, half of one, or two; and for the plan's ``bb`` and threads the
  widest staging tile at 2, 3 and 4 slots;
* ``--diagnose``: the plan's geometry on builds of the kernel that are
  wrong on purpose, each removing one cost — ``no_term_reads`` (constant
  terms, each row gathering itself; the staged ones unread),
  ``no_staging`` (that, and no copies after the first items), ``copies_only``
  (the copies and barriers, no row computed), ``no_fold`` (no slice folded
  into the sums).  Their differences split the time; their results are not
  checked.

One JSON object per configuration; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.layer_plan import (  # noqa: E402
    _launch_stage, device_stage, plan_stage)
from repro_torch.kernels.lcc_chain_matmul import (  # noqa: E402
    MAX_SUMS, SM_SMEM, SMEM_LIMIT, _align16, slot_bytes)

ENTRY = "repro_stage_matmul"
# diagnostic builds: (old, new) snippets of csrc/stage_matmul.cu
_QUAD_TERMS = ("""        const int4 j0 = reinterpret_cast<const int4*>(s_idx)[r];
        const char4 x0 = reinterpret_cast<const char4*>(s_exp)[r];
        const char4 g0 = reinterpret_cast<const char4*>(s_sign)[r];
        int4 j1 = make_int4(0, 0, 0, 0);
        char4 x1 = make_char4(0, 0, 0, 0), g1 = make_char4(0, 0, 0, 0);
        if (two) {
          j1 = reinterpret_cast<const int4*>(s_idx)[r2];
          x1 = reinterpret_cast<const char4*>(s_exp)[r2];
          g1 = reinterpret_cast<const char4*>(s_sign)[r2];
        }""", """        const int q0 = p ? base + r0 + r : 0, q1 = p ? base + r0 + r2 : 1;
        const int4 j0 = make_int4(q0, q0, q0, q0), j1 = make_int4(q1, q1, q1, q1);
        const char4 x0 = make_char4(-3, -4, -5, -6), g0 = make_char4(1, -1, 1, -1);
        const char4 x1 = x0, g1 = g0;""")
DIAGNOSTICS = {
    "no_term_reads": [_QUAD_TERMS],
    "no_staging": [_QUAD_TERMS, ("""      if (copier)
        stage_tile(pf, ring + ((i + stages - 1) % stages) * sbytes, idx, exp,
                   sign, l, P, R, S, tile, tid - T, kCopyThreads);
""", "")],
    "copies_only": [("""    for (int r = copier ? rows : tid; r < rows; r += 2 * T) {""",
                     """    for (int r = rows; r < rows; r += 2 * T) {""")],
    "no_fold": [("""    if (cur.p == cur.depth - 1 && cur.q == cur.nq - 1) {""",
                 """    if (false) {""")],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bind(path: Path):
    fn = getattr(ctypes.CDLL(str(path)), ENTRY)
    fn.argtypes = build._SIGNATURES[ENTRY]
    fn.restype = ctypes.c_int
    return fn


def diagnostic_builds(edits) -> dict:
    """One library an entry of ``edits`` (name -> snippets), built from an
    edited copy of ``stage_matmul.cu`` (all nvcc processes started
    together)."""
    csrc = build.CSRC
    body = (csrc / "stage_matmul.cu").read_text()
    procs = {}
    for name in edits:
        text = body
        for old, new in edits[name]:
            if old not in text:
                raise SystemExit(f"stage_sweep: diagnostic {name} no longer "
                                 "matches csrc/stage_matmul.cu")
            text = text.replace(old, new)
        d = build.build_dir() / "stage_sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "stage_matmul.cu").write_text(text)
        cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-I", str(csrc),
               "-shared", "-o", str(d / "lib.so"), str(d / "stage_matmul.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"stage_sweep: nvcc failed for {name}:\n{out}")
        libs[name] = bind(d / "lib.so")
    return libs


def staging_at(n, s, bb, threads, stages, budget=SMEM_LIMIT):
    """The widest tile (whole rows a thread, or the slice) at ``stages``."""
    buffers = _align16(2 * n * bb * 4)
    rpt = -(-n // threads)
    for rows in range(rpt, 0, -1):
        tile = n if rows == rpt else rows * threads
        if buffers + stages * slot_bytes(tile, s) <= budget:
            return tile, buffers + stages * slot_bytes(tile, s)
    return None


def sweep_configs(n, s, b, sm):
    """``(label, (bb, threads, tile, stages, per_sm), want)`` of the sweep."""
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
            per_sm = 2 if 2 * (st[1] + 1024) <= SM_SMEM and threads <= 256 else 1
            slots = sm * per_sm // -(-b // bb)
            for how, want in (("one wave", slots), ("half a wave", slots // 2),
                              ("two waves", 2 * slots)):
                out.append((f"bb={bb} T={threads} {how}",
                            (bb, threads, st[0], 2, per_sm), max(1, want)))
    bb, threads, _, _, per_sm = plan_stage(n, s, b)
    budget = SM_SMEM // 2 - 1024 if per_sm == 2 else SMEM_LIMIT
    for stages in (2, 3, 4):
        st = staging_at(n, s, bb, threads, stages, budget)
        if st is not None:
            out.append((f"plan geometry, {stages} slots",
                        (bb, threads, st[0], stages, per_sm), None))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None,
                    help="comma-separated words; keep labels containing one")
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_sweep: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    libs = {"kernel": getattr(build.load(), ENTRY)}
    if args.diagnose:
        libs.update(diagnostic_builds(DIAGNOSTICS))
    emit(dict(phase="build", card=smi, seconds=time.perf_counter() - t0))
    words = args.shapes.split(",") if args.shapes else None
    timer = cs.Timer(dev)
    # words that name an architecture keep only it (the others' artifacts
    # are not built)
    archs = [a for a in cs.STAGE_ARCHS if any(w in a for w in words or ())]
    archs = archs or list(cs.STAGE_ARCHS)
    for arch, host, cases, _ in cs.main_path_stages(dev, archs):
        emit(dict(phase="stage_arch", **host))
        for label, _, ps, batch in cases:
            if words and not any(w in label for w in words):
                continue
            ds = device_stage(ps, dev)
            src = cs.dyadic(np.random.default_rng(60), (ps.d_src, batch), dev)
            n, s = ds.max_rows, ds.dims["S"]
            configs = [("kernel", "plan", None, None)]
            configs += [(v, "plan", None, None) for v in libs if v != "kernel"]
            if not args.no_sweep:
                configs += [("kernel", name, geo, want)
                            for name, geo, want in sweep_configs(n, s, batch, sm)]
            if len(ds.launch(batch, 0, sm).groups) > 1:  # sites differ
                configs.insert(1, ("kernel", "one geometry (longest slice)",
                                   ds.geometry(batch), None))
            for v, name, geo, want in configs:
                plan = ds.make_launch(batch, 0, sm, geometry=geo, want=want)
                row = dict(shape=label, build=v, config=name,
                           geometries=plan.geometries, chunks=plan.n_units,
                           blocks=sum(g[1] * -(-batch // g[2])
                                      for g in plan.groups))

                def call(fn=libs[v], plan=plan):
                    return _launch_stage(ds, src, 0, None, plan, entry=fn)
                y = call()
                torch.cuda.synchronize()
                if v == "kernel":
                    want_y = cs.ordered_stage_plain(ps, src, 0, sm, plan=plan)
                    if (not (ds.fs_live[0] or ds.dw_live[0])
                            and not torch.equal(y, want_y)):
                        raise SystemExit(f"stage_sweep: {label} {name}: differs "
                                         "from the plain arithmetic in its order")
                row["ms"] = timer(call)
                emit(row)
            del ds, src
            torch.cuda.empty_cache()
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
