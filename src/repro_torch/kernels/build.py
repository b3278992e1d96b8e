"""Builds the CUDA kernels of ``csrc/`` at first use and binds them with ctypes.

Every ``*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with a plain C interface — no PyTorch headers, so a build takes seconds.  The
library lands in ``build/repro_torch/`` at the root of the checkout, named
after a hash of the sources and flags, so an unchanged tree builds once.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "build_dir", "sources", "NVCC_FLAGS", "last_build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None  # None until load() ran; 0.0 = cached

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # idx exp sign x c0 w len partial out | E P N S B C spb bb threads tile
    # stages | stream
    "repro_lcc_chain_matmul": [_P] * 9 + [_I] * 11 + [_P],
    # ... | G E P N S B C spb bb threads tile stages | stream
    "repro_lcc_group_matmul": [_P] * 9 + [_I] * 12 + [_P],
    # src segptr rowinfo x out | R B | member_stride row_stride col_stride |
    # bf16 | stream
    "repro_region_prep": [_P] * 5 + [_I] * 2 + [_L] * 3 + [_I, _P],
    # idx exp sign x out | N S K B x_bf16 | stream
    "repro_lcc_factor_matmul": [_P] * 5 + [_I] * 5 + [_P],
    # src prep_src prep_off inbuf gidx gexp gsgn slices holes units esites
    # ebegin partial fs dw bias resid out x slot wgt h2 src_tok | nl D B M K
    # P R S O | mode E k cap T d | groups (host int32 [G, 7]) | G | stream
    "repro_stage_matmul": [_P] * 23 + [_I] * 15 + [_P, _I, _P],
    # x w out | d B cols split threads mode | eps | stream
    "repro_step_norm": [_P] * 3 + [_I] * 6 + [_F, _P],
    # qkv pos cos sin kc vc kpos tbl att kn vn ws | B S nq nkv hd bs mb
    # window splits chunk | scale | stream
    "repro_split_attention": [_P] * 12 + [_I] * 10 + [_F, _P],
    # h2 router sel wgt slot src_tok dropped ws | d B E k cap norm_topk |
    # stream
    "repro_moe_route": [_P] * 8 + [_I] * 6 + [_P],
    # a out | G | M | t | dtype | stream
    "repro_group_prox": [_P, _P, _L, _I, _F, _I, _P],
}


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH, $CUDA_HOME, /usr/local/cuda)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> None:
    nvcc = _find_nvcc()
    out = lib_path.parent
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    procs = []
    for src in sources():  # one nvcc per source, all started together
        obj = out / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed, objs = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
        objs.append(obj)
        if proc.returncode != 0:
            failed.append(src.name)
    (out / "build.log").write_text("\n".join(log))
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp = out / f"{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp, lib_path)  # atomic: two processes that build at once both succeed
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if not built yet."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
    lib_path = build_dir() / f"librepro_torch_kernels-{_source_hash()}.so"
    t0 = time.perf_counter()
    if lib_path.exists():
        last_build_seconds = 0.0
    else:
        _build(lib_path)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
