"""Launch geometry of the shared K1/K2 chain body (``csrc/lcc_chain.cuh``).

The body runs only on the card; what the CPU can hold is the geometry that
``plan_launch`` / ``plan_staging`` hand it — shared-memory budget, register
sums, slice chunks — at every shape the serves launch it at, and the
kernel-order reference ``chip_smoke.ordered_plain`` that the card's results
are held against bit for bit.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.lcc_chain_matmul import (MAX_SUMS, SM_SMEM,
                                                  SMEM_LIMIT, _levels_plain,
                                                  _slice_inputs_plain,
                                                  launch_staging,
                                                  lcc_chain_matmul_plain,
                                                  plan_launch, plan_staging,
                                                  slot_bytes)
from repro_torch.testing import seeded_decomposition

ROOT = Path(__file__).resolve().parents[1]
CUH = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "lcc_chain.cuh"
SM = 132  # H100 SXM

# (label, N, B, G, E, bb): the K1/K2 launches of the olmo-1b, mixtral-8x22b
# and deepseek-v2-lite-16b per-region serves (chip_smoke.chain_cases), ROADMAP
# B1's qwen2-vl FFN widths, the widest launches of the dense family's and
# the VLM's serves, and every launch of the recurrent families' and
# whisper's serves (the fixture's E)
MAIN_PATH = [
    ("olmo attn.o", 2048, 8, 1, 175, 8),
    ("olmo ffn.down", 2048, 8, 1, 745, 8),
    ("olmo attn.qkv", 2048, 8, 3, 186, 8),
    ("olmo ffn.gate+up", 8192, 8, 2, 158, 2),
    ("mixtral attn.o", 6144, 8, 1, 443, 2),
    ("mixtral attn.qkv", 6144, 8, 3, 615, 2),
    ("mixtral moe.gate", 16384, 4, 8, 439, 1),
    ("mixtral moe.up", 16384, 4, 8, 412, 1),
    ("mixtral moe.down", 6144, 4, 8, 1261, 2),
    ("deepseek attn.q", 3072, 8, 1, 171, 4),
    ("deepseek attn.o", 2048, 8, 1, 175, 8),
    ("deepseek shared down", 2048, 8, 1, 256, 8),
    ("deepseek dkv+kr", 512, 8, 2, 341, 8),
    ("deepseek uk+uv", 2048, 1024, 2, 47, 8),
    ("deepseek shared gate+up", 2816, 8, 2, 186, 4),
    ("deepseek moe.gate", 1408, 4, 64, 205, 4),
    ("deepseek moe.up", 1408, 4, 64, 192, 4),
    ("deepseek moe.down", 2048, 4, 64, 128, 4),
    ("qwen2-vl ffn.gate+up", 18944, 8, 2, 100, 1),
    ("qwen ffn.gate+up", 11008, 8, 2, 100, 1),
    ("qwen2.5 ffn.gate+up", 11008, 8, 2, 158, 1),
    ("qwen2.5 ffn.down", 2048, 8, 1, 1001, 8),
    ("llama3.2 ffn.gate+up", 8192, 8, 2, 237, 2),
    ("yi ffn.gate+up", 11008, 8, 2, 315, 1),
    ("yi attn.q+k+v", 4096, 8, 3, 455, 4),
    ("qwen2-vl-7b ffn.gate+up", 18944, 8, 2, 256, 1),
    ("qwen2-vl-7b ffn.down", 3584, 8, 1, 1579, 4),
    ("qwen2-vl-7b attn.q+k+v", 3584, 8, 3, 398, 4),
    # the recurrent families' per-region serves (fixture widths)
    ("rwkv6 tm.o", 2048, 8, 1, 175, 8),
    ("rwkv6 cm.v", 2048, 8, 1, 652, 8),
    ("rwkv6 tm.r+k+v+g", 2048, 8, 4, 186, 8),
    ("rwkv6 cm.k+r", 7168, 8, 2, 186, 2),
    ("zamba2 mamba.in_proj", 14576, 8, 1, 240, 1),
    ("zamba2 mamba.out_proj", 3584, 8, 1, 598, 4),
    ("zamba2 shared attn.o", 3584, 8, 1, 280, 4),
    ("zamba2 shared ffn.down", 3584, 8, 1, 1195, 4),
    ("zamba2 shared attn.q+k+v", 3584, 8, 3, 299, 4),
    ("zamba2 shared ffn.gate+up", 14336, 8, 2, 256, 1),
    # whisper-small's decoder (per-region serve, fixture widths)
    ("whisper dec.attn.o|xattn.q", 768, 8, 1, 77, 8),
    ("whisper dec.xattn.o", 768, 8, 1, 72, 8),
    ("whisper dec.mlp.fc1", 3072, 8, 1, 60, 4),
    ("whisper dec.mlp.fc2", 768, 8, 1, 307, 8),
    ("whisper dec.attn.q+k+v", 768, 8, 3, 77, 8),
]
LARGEST_N_BB1 = 26164  # at S = 2: 8 N + two 960-row slots <= SMEM_LIMIT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_plan(n, b, g, e, s=2):
    bb, threads, chunks, spb = plan_launch(n, b, g, e, SM, s)
    tile, stages, smem = launch_staging(n, s, bb, threads)
    rpt = -(-n // threads)
    assert threads % 32 == 0 and 32 <= threads <= 960  # + two copy warps
    # blocks above 512 threads only for one column at more than 16384 rows
    assert threads <= 512 or (bb == 1 and n > 16384)
    assert rpt * bb <= MAX_SUMS  # a thread's register sums
    assert smem <= SMEM_LIMIT
    if threads == 256:  # two blocks a SM
        assert 2 * (smem + 1024) <= SM_SMEM
    assert smem == -(-2 * n * bb * 4 // 16) * 16 + stages * slot_bytes(tile, s)
    assert stages in (2, 3)
    # a tile is whole rows of every thread, or the whole factor
    assert tile >= n or tile % threads == 0
    assert chunks * spb >= e > (chunks - 1) * spb  # every slice, no empty block
    assert chunks <= e
    return bb, threads, chunks, spb, tile, stages


@pytest.mark.parametrize("label,n,b,g,e,want_bb", MAIN_PATH,
                         ids=[c[0] for c in MAIN_PATH])
def test_plan_fits_buffers_and_staging_ring(label, n, b, g, e, want_bb):
    bb, threads, chunks, _, _, _ = _check_plan(n, b, g, e)
    assert bb == want_bb
    # one wave: every block of the launch has its slot on the card
    per_sm = 2 if threads == 256 else 1
    assert g * -(-b // bb) * chunks <= max(SM * per_sm, g * -(-b // bb))


@pytest.mark.parametrize("n,s", [(2048, 2), (16384, 2), (6144, 3), (64, 1),
                                 (1000, 2), (129, 3), (8192, 2), (18944, 2)])
def test_plan_staging_takes_few_even_items(n, s):
    threads = min(512, -(-n // 32) * 32)
    rpt = -(-n // threads)
    for bb in (1, 2, 4, 8):
        got = plan_staging(n, s, bb, threads)
        if got is None:
            continue
        tile, stages, smem = got
        buffers = -(-2 * n * bb * 4 // 16) * 16
        assert smem == buffers + stages * slot_bytes(tile, s) <= SMEM_LIMIT
        items = -(-n // tile)
        if buffers + 2 * slot_bytes(n, s) <= SMEM_LIMIT:
            assert tile == n  # a whole factor a slot whenever two fit
        else:
            # one item fewer would need a tile that two slots cannot hold
            fewer = min(n, -(-rpt // (items - 1)) * threads)
            assert buffers + 2 * slot_bytes(fewer, s) > SMEM_LIMIT
            # the narrowest tile of whole rows a thread that covers N in as
            # many items: the rows spread as evenly as that allows
            assert tile == -(-rpt // items) * threads
        # three slots whenever they fit
        assert stages == (3 if buffers + 3 * slot_bytes(tile, s) <= SMEM_LIMIT
                          else 2)


def test_largest_rows_at_one_column():
    assert _check_plan(LARGEST_N_BB1, 8, 1, 10)[0] == 1
    with pytest.raises(NotImplementedError):
        plan_launch(LARGEST_N_BB1 + 1, 8, 1, 10, SM)
    # fewer terms a row stage fewer bytes: one more row still fits at S = 1
    assert plan_launch(LARGEST_N_BB1 + 1, 8, 1, 10, SM, 1)[0] == 1


@pytest.mark.parametrize("seed", range(6))
def test_chunks_cover_every_slice(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 20000))
        b, g, e = (int(rng.integers(1, 2048)), int(rng.integers(1, 80)),
                   int(rng.integers(1, 1500)))
        _check_plan(n, b, g, e)


def test_header_constants_match_the_planner():
    src = CUH.read_text()
    assert int(re.search(r"kMaxDynamicSmem = (\d+)", src).group(1)) == SMEM_LIMIT
    assert int(re.search(r"kMaxSums = (\d+)", src).group(1)) == MAX_SUMS
    # the body stages its streams with cp.async and keeps to one SM
    assert "cp.async.cg.shared.global" in src
    for absent in ("__cluster_dims__", "cudaLaunchKernelEx", "cp.async.bulk",
                   "mbarrier", "wgmma", "CUtensorMap"):
        assert absent not in src


def test_chain_cases_cover_the_serves_and_fit():
    cs = _chip_smoke()
    cases = {label: (batch, members)
             for arch in ("olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b")
             for label, _, batch, members in cs.chain_cases(arch)}
    assert len(cases) == 18
    assert cases["deepseek-v2-lite-16b attn.uk+uv B=1024"][1] == [(2048, 510)] * 2
    assert cases["mixtral-8x22b moe.up G=8 B=4"][1] == [(16384, 5759)] * 8
    from repro_torch.core.lcc import plan_col_slices
    for batch, members in cases.values():
        n = max(m[0] for m in members)
        e = max(len(plan_col_slices(*m)) for m in members)
        _check_plan(n, batch, len(members), e)


def test_chain_cases_cover_the_dense_family_and_the_vlm():
    """The four new serves' launches: attn.o, ffn.down, q+k+v (k and v
    padded to q's rows) and gate+up, each fitting the planner; qwen2-vl's
    18944 rows at one column on 960 row threads."""
    cs = _chip_smoke()
    from repro_torch.core.lcc import plan_col_slices
    archs = ("qwen2.5-3b", "llama3.2-3b", "yi-9b", "qwen2-vl-7b")
    cases = {label: (batch, members) for arch in archs
             for label, _, batch, members in cs.chain_cases(arch)}
    assert len(cases) == 16
    assert cases["qwen2-vl-7b attn.q+k+v B=8"][1] == [
        (3584, 3582), (512, 3359), (512, 3582)]
    assert cases["qwen2-vl-7b ffn.gate+up B=8"][1] == [(18944, 3582),
                                                       (18944, 3359)]
    assert cases["qwen2.5-3b ffn.down B=8"][1] == [(2048, 11006)]
    for batch, members in cases.values():
        n = max(m[0] for m in members)
        e = max(len(plan_col_slices(*m)) for m in members)
        _check_plan(n, batch, len(members), e)
    assert plan_launch(18944, 8, 2, 256, SM)[:2] == (1, 960)


def test_chain_cases_cover_the_recurrent_serves():
    """The recurrent serves' launches: rwkv6's r+k+v+g (four members of
    2048 rows) and k+r (r padded to k's 7168 rows, as the reference groups
    them), o and v; zamba2's in/out projections (14576 = 2 x 7168 + 2 x 64 +
    112 rows) and the shared block's q+k+v, o, gate+up (14336 rows at one
    column) and down, each fitting the planner."""
    cs = _chip_smoke()
    from repro_torch.core.lcc import plan_col_slices
    cases = {label: (batch, members)
             for arch in ("rwkv6-1.6b", "zamba2-7b")
             for label, _, batch, members in cs.chain_cases(arch)}
    assert len(cases) == 10
    assert cases["rwkv6-1.6b tm.r+k+v+g B=8"][1] == [
        (2048, 2046), (2048, 1919), (2048, 2046), (2048, 2046)]
    assert cases["rwkv6-1.6b cm.k+r B=8"][1] == [(7168, 1919), (2048, 2046)]
    assert cases["zamba2-7b mamba.in_proj B=8"][1] == [(14576, 3359)]
    assert cases["zamba2-7b shared_attn.ffn.gate+up B=8"][1] == [
        (14336, 3582), (14336, 3359)]
    for batch, members in cases.values():
        n = max(m[0] for m in members)
        e = max(len(plan_col_slices(*m)) for m in members)
        _check_plan(n, batch, len(members), e)
    assert plan_launch(14336, 8, 2, 256, SM)[:2] == (1, 512)
    assert plan_launch(14576, 8, 1, 240, SM)[:2] == (1, 512)


def test_chain_cases_cover_whisper():
    """whisper-small's decoder launches: q+k+v (k weight-shared), one
    launch shape for attn.o and xattn.q (the same N and kept K, neither
    shared: one case naming both), xattn.o, fc1 (3072 rows) and fc2; the
    encoder's sites and xattn.k/v launch nothing in decode."""
    cs = _chip_smoke()
    from repro_torch.core.lcc import plan_col_slices
    cases = {label: (names, batch, members)
             for label, names, batch, members in cs.chain_cases("whisper-small")}
    assert sorted(cases) == sorted(
        f"whisper-small {s} B=8" for s in (
            "dec.attn.o|dec.xattn.q", "dec.xattn.o", "dec.mlp.fc1",
            "dec.mlp.fc2", "dec.attn.q+k+v"))
    assert cases["whisper-small dec.attn.q+k+v B=8"][2] == [
        (768, 766), (768, 719), (768, 766)]
    assert cases["whisper-small dec.mlp.fc2 B=8"][2] == [(768, 3070)]
    for names, batch, members in cases.values():
        assert all(n.startswith("dec.") and not n.startswith(
            ("dec.xattn.k", "dec.xattn.v")) for n in names)
        n = max(m[0] for m in members)
        e = max(len(plan_col_slices(*m)) for m in members)
        _check_plan(n, batch, len(members), e)


@pytest.mark.parametrize("sm", [1, 8, 132])
def test_ordered_plain_follows_plan_launch(sm):
    """chip_smoke.ordered_plain sums the plain per-slice results in the
    kernel's order: slice by slice inside each of plan_launch's chunks, then
    chunk by chunk; with one chunk that is plain slice order."""
    cs = _chip_smoke()
    rng = np.random.default_rng(7)
    pk = ops.pack_decomposition(seeded_decomposition(96, 80, rng))
    ds = pk.on("cpu")
    x = torch.from_numpy(rng.standard_normal((80, 5)).astype(np.float32))
    got = cs.ordered_plain(ds, x, sm)
    e, _, n, s = pk.idx.shape
    _, _, chunks, spb = plan_launch(n, 5, 1, e, sm, s)
    per = _levels_plain(ds.idx, ds.exp, ds.sign,
                        _slice_inputs_plain(x, ds.slice_c0, ds.slice_w,
                                            max(n, int(ds.slice_w.max()))))
    live = ds.chain_len > 0
    want = torch.zeros((n, 5))
    for c in range(chunks):
        acc = None
        for ei in range(c * spb, min(e, (c + 1) * spb)):
            if live[ei]:
                acc = per[ei] if acc is None else acc + per[ei]
        if acc is not None:
            want = want + acc
    assert torch.equal(got[0], want)
    if sm == 1:
        assert chunks == 1
    else:
        assert chunks > 1
    plain = lcc_chain_matmul_plain(ds.idx, ds.exp, ds.sign, x, ds.slice_c0,
                                   ds.slice_w)
    torch.testing.assert_close(got[0], plain, rtol=0, atol=2e-5)
