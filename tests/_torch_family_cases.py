"""Cases and checks shared by ``tests/test_torch_sharded_families.py`` (the
families' raw parameters and olmo-1b's tokenwise prefill),
``tests/test_torch_sharded_families_compressed.py`` (deepseek-v2-lite-16b's
and qwen2-vl-7b's bf16 artifacts, per-region, and deepseek's float32
artifact, K9) and ``tests/test_torch_sharded_families_recurrent.py``
(rwkv6-1.6b's, zamba2-7b's and whisper-small's bf16 artifacts):
``ServingEngine(mesh=)``
at 2 gloo ranks over ``SERVE_MESHES``' two (2, 1) meshes against the
unsharded port engine and the reference's single-device ``ServingEngine``.

The reduced configs are the families' own tests': deepseek-v2-lite-16b's
of ``test_torch_deepseek.py`` (MLA, 4 experts top-2 and a shared one),
qwen2-vl-7b's of ``test_torch_vlm.py`` (m-RoPE, non-zero q/k/v biases),
rwkv6-1.6b's and zamba2-7b's (5 layers) of ``test_torch_recurrent_serving
.py``, whisper-small's of ``test_torch_whisper.py`` (biases and perturbed
LayerNorms; the cross-KV the reference's recipe over seeded frames, each
rank placing its share), and the reduced olmo-1b with
``bulk_prefill=False``.  The reference's engines serve the raw parameters
and the artifacts' dense-effective weights (``use_kernel=False``).

The collectives of one decode step are predicted by :func:`predicted_step`
from the reference's own policy (``repro.distributed.sharding`` over a
stub mesh) and the uses each family's step makes of its leaves."""
import dataclasses
import math
from collections import OrderedDict
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

import _torch_dist_workers as workers
from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import MoESpec as JMoESpec
from repro.configs.base import SSMSpec as JSSMSpec
from repro.configs.base import reduced_config as jreduced
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine

from repro_torch.convert import (artifact_from_reference,
                                 config_from_reference, params_from_numpy)

from test_torch_vlm import SMALL as VLM_SMALL
from test_torch_vlm import with_biases
from test_torch_whisper import reference_cross_kv, reference_tree

TIMEOUT = 150.0
LOGIT_TOL = 1e-4
BF16_ULPS = 4
MAX_LEN = 32
ARCHS = ("deepseek-v2-lite-16b", "qwen2-vl-7b", "rwkv6-1.6b", "zamba2-7b",
         "whisper-small")
MESHES = tuple(workers.SERVE_MESHES)


def reference_config(arch: str):
    if arch == "deepseek-v2-lite-16b":
        return jreduced(jget_arch(arch), d_model=32, n_heads=2, n_kv_heads=2,
                        vocab=64, n_layers=2,
                        moe=JMoESpec(n_experts=4, top_k=2, d_ff_expert=16,
                                     n_shared=1, capacity_factor=1.25))
    if arch == "qwen2-vl-7b":
        return jreduced(jget_arch(arch), **VLM_SMALL)
    if arch == "rwkv6-1.6b":
        return jreduced(jget_arch(arch), d_model=64, head_dim=16, d_ff=96,
                        vocab=64)
    if arch == "zamba2-7b":
        return jreduced(jget_arch(arch), n_layers=5, d_model=64, n_heads=4,
                        n_kv_heads=4, head_dim=16, d_ff=96, vocab=64,
                        ssm=JSSMSpec(d_inner=64, d_state=16, head_dim=16,
                                     d_conv=4))
    if arch == "whisper-small":
        return reference_tree()[0]
    return jreduced(jget_arch(arch))


def _reference_tree(arch: str, jcfg) -> dict:
    if arch == "whisper-small":
        return reference_tree()[1]
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    if arch == "qwen2-vl-7b":
        return with_biases(jp, 1)
    return jax.tree.map(np.asarray, jp)


def _bf16(jart):
    cfg = dataclasses.replace(jart.config, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jart.params)
    return dataclasses.replace(jart, config=cfg, params=params)


def _reference(jcfg, tree=None, jart=None, cross=None, bulk=True) -> dict:
    """The reference engine's tokens on the workers' prompts and its logits
    of one step at their ``tok``/``pos`` on a fresh state."""
    kw = dict(n_slots=4, max_len=MAX_LEN, metrics=False, bulk_prefill=bulk)
    eng = (JEngine(artifact=jart, use_kernel=False, **kw) if jart is not None
           else JEngine(jax.tree.map(jnp.asarray, tree), jcfg, **kw))
    st0 = japi.init_decode_state(eng.cfg, 4, MAX_LEN, kv_block=16)
    if cross is not None:
        eng.state = dict(eng.state, **cross)
        st0 = dict(st0, **cross)
    toks = [r.tokens for r in eng.generate(workers.SERVE_PROMPTS, 6)]
    logits, _ = eng._decode(eng.params, st0,
                            jnp.asarray(workers.LOGIT_TOK, jnp.int32),
                            jnp.asarray(workers.LOGIT_POS, jnp.int32))
    return dict(tokens=toks, logits=np.asarray(logits.astype(jnp.float32)))


def build_cases(names) -> tuple[dict, dict, dict]:
    """``(port cases, the reference's outputs, the reference configs)`` of
    ``names`` (``"<arch>:raw"``, ``":bf16"``, ``":f32"``,
    ``"olmo-1b:tokenwise"``): the port's on the CPU."""
    port, ref, jcfgs = {}, {}, {}
    for arch in dict.fromkeys(n.split(":")[0] for n in names):
        jcfg = reference_config(arch)
        tree = _reference_tree(arch, jcfg)
        tcfg = config_from_reference(jcfg)
        cross = None
        if arch == "whisper-small":  # each slot's frames through the encoder
            frames = np.random.default_rng(5).standard_normal(
                (4, MAX_LEN, jcfg.d_model)).astype(np.float32)
            ck, cv = reference_cross_kv(jcfg, jax.tree.map(jnp.asarray, tree),
                                        frames)
            cross = {"cross_k": ck, "cross_v": cv}
        extra = {} if cross is None else {
            "cross": {k: np.asarray(v) for k, v in cross.items()}}
        kinds = [n.split(":")[1] for n in names if n.startswith(arch + ":")]
        for kind in kinds:
            if kind in ("raw", "tokenwise"):
                bulk = kind == "raw"
                port[f"{arch}:{kind}"] = dict(
                    params=params_from_numpy(tree, tcfg, "cpu"), cfg=tcfg,
                    max_len=MAX_LEN, bulk=bulk, **extra)
                ref[f"{arch}:{kind}"] = _reference(jcfg, tree=tree,
                                                   cross=cross, bulk=bulk)
                jcfgs[f"{arch}:{kind}"] = jcfg
        if not {"bf16", "f32"} & set(kinds):
            continue
        jart = japi.compress_model(
            jax.tree.map(jnp.asarray, tree), jcfg, jcore.CompressionConfig(
                algorithm="fp", weight_sharing=True, max_share_rel_err=0.06))
        for kind in {"bf16", "f32"} & set(kinds):
            art = _bf16(jart) if kind == "bf16" else jart
            port[f"{arch}:{kind}"] = dict(
                artifact=artifact_from_reference(art, "cpu"),
                max_len=MAX_LEN, **extra)
            ref[f"{arch}:{kind}"] = _reference(art.config, jart=art,
                                               cross=cross)
            jcfgs[f"{arch}:{kind}"] = art.config
    return port, ref, jcfgs


# ------------------------------------------------------------- the predictor


def _stub(mesh_name: str):
    """The mesh as the reference's policy reads it (``.shape``): a (2, 1)
    mesh of ``SERVE_MESHES`` or the 1 x 1 ("data", "model") mesh."""
    if mesh_name == "1x1":
        return SimpleNamespace(shape=OrderedDict(data=1, model=1))
    return SimpleNamespace(shape=OrderedDict(
        zip(workers.SERVE_MESHES[mesh_name], (2, 1))))


def _flat(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat}


def reference_specs(jcfg, mesh_name: str) -> dict:
    """{leaf path: spec} of the reference's policy for ``jcfg``'s
    parameters over the mesh (its policy reads only ``.shape``)."""
    abstract = japi.abstract_params(jcfg)
    specs = jsh.params_pspecs(abstract, _stub(mesh_name))
    return {k: tuple(v) for k, v in _flat(
        specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)).items()}


def reference_state_specs(jcfg, mesh_name: str, paged: bool) -> dict:
    state = jax.eval_shape(lambda: japi.init_decode_state(
        jcfg, 4, MAX_LEN, kv_block=16 if paged else None))
    specs = jsh.decode_state_pspecs(state, _stub(mesh_name))
    return {k: tuple(v) + (None,) * (len(state[k].shape) - len(v))
            for k, v in specs.items()}


def _cost(use: str, spec: tuple) -> tuple[int, int]:
    """``(all_gather, all_reduce)`` of one use of a leaf of per-layer
    ``spec`` (``tp``'s rules): ``whole`` gathers each named axis; a
    product (``linear [K, N]``, ``embed [V, d]``, ``experts [E, d, f]``,
    the tied ``head``, ``embed.T``) gathers its axes but "model" (FSDP
    storage), then all-reduces where "model" splits the contracted (or
    looked-up) dimension and gathers where it splits another."""
    named = [(d, e) for d, e in enumerate(spec) if e is not None]
    if use == "whole":
        return len(named), 0
    ag = sum(1 for _, e in named if e != "model")
    md = next((d for d, e in named if e == "model"), None)
    if use == "head":
        md, use = (None if md is None else 1 - md), "linear"
    if md is None:
        return ag, 0
    reduced = {"linear": 0, "embed": 0, "experts": 1}[use]
    return (ag, 1) if md == reduced else (ag + 1, 0)


def _attention(split: int) -> tuple[int, int]:
    """A decode attention over a cache split on ``split`` (-1 head_dim:
    the partial scores all-reduced, the output gathered; -2 the kv heads:
    the output gathered)."""
    return (1, 1) if split == -1 else (1, 0)


def _model_dim(spec) -> int:
    return next(d for d, e in enumerate(spec) if e == "model") - len(spec)


def _uses(jcfg, routed: bool, splits: dict) -> list:
    """The step's uses ``(leaf path, use)`` and its state collectives
    ``(None, (all_gather, all_reduce))``.  ``routed``: the per-region
    route, where a compressed site's weight runs whole (its bias still
    gathered at use)."""
    out = [("embed", "embed")]

    def lin(path, bias=False):
        if not routed:
            out.append((f"{path}/w", "linear"))
        if bias:
            out.append((f"{path}/b", "whole"))

    def state(n):
        out.append((None, n))

    family = jcfg.family
    rms = jcfg.norm == "rms"
    if jcfg.enc_layers > 0:  # whisper's decoder
        out.append(("dec_pos", "embed"))
        att = _attention(splits["self_k"])
        for li in range(jcfg.n_layers):
            b = f"dec_blocks/{li}"
            for ln in ("ln1", "ln_x", "ln2"):
                out += [(f"{b}/{ln}/w", "whole"), (f"{b}/{ln}/b", "whole")]
            for proj in ("q", "k", "v"):
                lin(f"{b}/attn/{proj}", bias=True)
            state(att)
            lin(f"{b}/attn/o")
            lin(f"{b}/xattn/q", bias=True)
            state(att)
            lin(f"{b}/xattn/o")
            lin(f"{b}/mlp/fc1", bias=True)
            lin(f"{b}/mlp/fc2", bias=True)
        out.append(("embed", "head"))
        return out
    if family == "ssm":
        for li in range(jcfg.n_layers):
            b = f"blocks/{li}"
            out += [(f"{b}/ln1", "whole"), (f"{b}/ln2", "whole")]
            state((1, 0))  # x_prev_tm gathered whole (rule b)
            out += [(f"{b}/tm/mix_A", "linear"), (f"{b}/tm/mix_B", "experts"),
                    (f"{b}/tm/mix_mu", "whole")]
            for proj in ("r", "k", "v", "g"):
                lin(f"{b}/tm/{proj}")
            out += [(f"{b}/tm/wA", "linear"), (f"{b}/tm/wB", "linear"),
                    (f"{b}/tm/w0", "whole"), (f"{b}/tm/u", "whole")]
            state((0, 1))  # r . S over the key axis (rule a)
            out.append((f"{b}/tm/ln_w", "whole"))
            lin(f"{b}/tm/o")
            state((1, 0))  # x_prev_cm (rule b)
            out.append((f"{b}/cm/mix_mu_k", "whole"))
            for proj in ("k", "r", "v"):
                lin(f"{b}/cm/{proj}")
    elif family == "hybrid":
        ssm = (0, 1) if splits["ssm"] == -2 else (1, 0)
        att = _attention(splits["attn_k"])
        period = jcfg.hybrid_period
        for li in range(jcfg.n_layers):
            b = f"blocks/{li}"
            out.append((f"{b}/ln1", "whole"))
            lin(f"{b}/mamba/in_proj")
            state((1, 0))  # the conv window gathered whole (rule b)
            out += [(f"{b}/mamba/{n}", "whole")
                    for n in ("conv_w", "conv_b", "dt_bias", "A_log")]
            state(ssm)  # C . h: a partial sum over N, or P's slices
            out += [(f"{b}/mamba/D", "whole"), (f"{b}/mamba/norm_w", "whole")]
            lin(f"{b}/mamba/out_proj")
            if (li + 1) % period == 0 and li < jcfg.n_layers // period * period:
                # the weight-shared block after each group
                s = "shared_attn"
                out.append((f"{s}/ln1", "whole"))
                for proj in ("q", "k", "v"):
                    lin(f"{s}/attn/{proj}")
                state(att)
                lin(f"{s}/attn/o")
                out.append((f"{s}/ln2", "whole"))
                for proj in ("gate", "up", "down"):
                    lin(f"{s}/ffn/{proj}")
    else:  # dense, vlm, MoE with MLA
        for li in range(jcfg.n_layers):
            b = f"blocks/{li}"
            if rms:
                out.append((f"{b}/ln1", "whole"))
            if jcfg.mla is not None:
                lin(f"{b}/attn/dkv")
                lin(f"{b}/attn/kr")
                state((2, 0))  # c_kv and k_rope gathered whole (rule b)
                for proj in ("q", "uk", "uv", "o"):
                    lin(f"{b}/attn/{proj}")
            else:
                for proj in ("q", "k", "v"):
                    lin(f"{b}/attn/{proj}", bias=jcfg.qkv_bias)
                state(_attention(splits["k"]))
                lin(f"{b}/attn/o")
            if rms:
                out.append((f"{b}/ln2", "whole"))
            if jcfg.moe is not None:
                out.append((f"{b}/ffn/router", "linear"))
                if not routed:
                    out += [(f"{b}/ffn/{p}", "experts")
                            for p in ("gate", "up", "down")]
                for proj in ("gate", "up", "down"):
                    lin(f"{b}/ffn/shared/{proj}")
            else:
                for proj in ("gate", "up", "down"):
                    lin(f"{b}/ffn/{proj}")
    out.append(("final_ln", "whole"))
    out.append(("embed", "head") if jcfg.tie_embeddings
               else ("lm_head/w", "linear"))
    return out


def predicted_step(jcfg, routed: bool, mesh_name: str, paged: bool,
                   slots_split: bool) -> dict:
    """The collectives of one decode step: each use's (:func:`_cost`) at
    the reference policy's spec of its leaf (a stacked leaf's spec without
    its layer axis), the state's by the rules of ``tp``'s docstring, and
    the packed tokens gathered over "data" when the slots split."""
    specs = reference_specs(jcfg, mesh_name)
    sspecs = reference_state_specs(jcfg, mesh_name, paged)
    splits = {k: _model_dim(v) for k, v in sspecs.items()
              if "model" in v}
    ag, ar = int(slots_split), 0
    for path, use in _uses(jcfg, routed, splits):
        if path is None:
            g, r = use
        else:
            parts = path.split("/")
            stacked = parts[0] in ("blocks", "dec_blocks")
            key = "/".join(parts[:1] + parts[2:]) if stacked else path
            spec = specs[key][1:] if stacked else specs[key]
            g, r = _cost(use, spec)
        ag, ar = ag + g, ar + r
    return {"all_gather": ag, "all_reduce": ar}


# ------------------------------------------------------------------ checks


def check_tokens(ref, run, unsharded, case, mesh) -> None:
    """Both ranks' tokens are the unsharded port engine's, which are the
    reference engine's (on a paged engine the shared-prefix pair's too:
    deepseek's MLA takes the tail prefill against the gathered prefix).  In bf16 the two packages round apart (the
    reference's compiled chains of elementwise ops round once, eager
    PyTorch after each op; the one-step logits agree within BF16_ULPS), and
    a near tie can flip a later greedy token on the unsharded engine
    already (rwkv6-1.6b's second generated token in two of four
    requests): there the reference holds each request through its first
    generated token."""
    r0, r1 = run[0][(case, mesh)], run[1][(case, mesh)]
    want = unsharded[case]
    assert r0["errors"] == r1["errors"] == [None] * 4
    assert r0["tokens"] == r1["tokens"] == want["tokens"]
    got, ref_toks = want["tokens"], ref[case]["tokens"]
    if case.endswith(":bf16"):
        got, ref_toks = ([t[:len(p) + 1] for t, p in
                          zip(toks, workers.SERVE_PROMPTS)]
                         for toks in (got, ref_toks))
    assert got == ref_toks
    assert r0["kinds"] == want["kinds"]
    # a paged engine: the shared-prefix pair (slots 0 and 2) as unsharded;
    # a prefix hit where the prefix cache is on (off for m-RoPE)
    assert r0.get("shared") == r1.get("shared") == want.get("shared")
    assert r0.get("shared_pool") == want.get("shared_pool")
    if case.startswith("deepseek"):
        assert want["shared_pool"]["prefix_hit_tokens"] >= 16


def check_logits(ref, run, unsharded, case, mesh) -> None:
    want = ref[case]["logits"]
    tol = LOGIT_TOL
    if case.endswith(":bf16"):  # ulp(x) = 2^(floor(log2 |x|) - 7)
        tol = BF16_ULPS * 2.0 ** (math.floor(math.log2(np.abs(want).max()))
                                  - 7)
    for rank in (0, 1):
        got = run[rank][(case, mesh)]["logits"]
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_allclose(got, unsharded[case]["logits"], rtol=0,
                                   atol=LOGIT_TOL)


def check_plan_stats(run, unsharded, case, mesh) -> None:
    """The unsharded engine's plan stats and launches a step; the slots
    split over a 2-way "data" axis but the MoE family's, which replicates
    them (the reference's rule, ``replicate:moe``)."""
    want = unsharded[case]
    moe = case.startswith("deepseek")
    for rank in (0, 1):
        got = run[rank][(case, mesh)]
        st = dict(got["plan_stats"])
        ms = st.pop("mesh")
        assert st == want["plan_stats"]
        assert got["launches"] == want["launches"]
        split = mesh == "data" and not moe
        assert ms["slot_axes"] == ("data" if split else None)
        assert ms["local_slots"] == ((2 * rank, 2 * rank + 2) if split
                                     else (0, 4))
        assert ms["fallbacks"] == ({"slots": "replicate:moe"}
                                   if moe and mesh == "data" else {})


def check_stored_bytes(jcfgs, run, case, mesh) -> None:
    """Each rank holds the reference policy's share of every parameter and
    of every decode-state leaf (the slot axis over "data" where the slots
    split, a paged pool's block axis whole), no more."""
    sizes = dict(zip(workers.SERVE_MESHES[mesh], (2, 1)))
    specs = reference_specs(jcfgs[case], mesh)
    for rank in (0, 1):
        got = run[rank][(case, mesh)]
        for name, (local, spec, whole) in got["param_leaves"].items():
            assert spec == specs[name] + (None,) * (len(whole) - len(
                specs[name])), name
            parts = math.prod(sizes[e] for e in spec if e is not None)
            assert math.prod(local) * parts == math.prod(whole), name
        paged = "block_tbl" in got["state_leaves"]
        want = reference_state_specs(jcfgs[case], mesh, paged)
        split = got["plan_stats"]["mesh"]["slot_axes"]
        for name, (local, spec, whole, _) in got["state_leaves"].items():
            exp = list(want[name])
            if name != "block_tbl":
                exp[1] = None if paged and name not in ("kpos",) else split
            assert spec == tuple(exp), name
            parts = math.prod(sizes[e] for e in spec if e is not None)
            assert math.prod(local) * parts == math.prod(whole), name


def check_collectives(jcfgs, port, run, case, mesh) -> None:
    """The collectives of one step: as :func:`predicted_step` says, and as
    the dry run reckons them on the meta device
    (``launch.dryrun.decode_collectives``; ``routed=True`` on an artifact,
    the stand-in of ``RoutedSites`` for its compressed sites)."""
    c = port[case]
    routed = c.get("artifact") is not None
    split = mesh == "data" and not case.startswith("deepseek")
    for rank in (0, 1):
        got = run[rank][(case, mesh)]
        paged = "block_tbl" in got["state_leaves"]
        want = predicted_step(jcfgs[case], routed, mesh, paged, split)
        assert got["step_counts"] == want == got["reckoned_step"], (
            rank, got["step_counts"], want, got["reckoned_step"])


def check_one_by_one(jcfgs, port, run, case) -> None:
    """A 1 x 1 mesh of rank 0: the unsharded engine's tokens and logits bit
    for bit, its launches, the predicted collectives."""
    got = run[0][(case, "1x1")]
    assert got["errors"] == [None] * 4
    assert got["tokens"] and got["logits"]
    assert got["launches"][0] == got["launches"][1]
    assert (case, "1x1") not in run[1]
    paged = "block_tbl" in run[0][(case, "model")]["state_leaves"]
    assert got["counts"] == got["reckoned"] == predicted_step(
        jcfgs[case], port[case].get("artifact") is not None, "1x1", paged,
        slots_split=False)
