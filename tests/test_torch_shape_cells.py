"""The port's shape cells and analytic counts against the JAX package's, for
all ten archs x the four cells (40 pairs): ``SHAPE_CELLS``,
``ArchConfig.sub_quadratic`` and ``cell_supported`` (reasons letter for
letter), ``input_specs`` (keys, shapes and dtypes against the reference's
``ShapeDtypeStruct``s; the port's on the ``meta`` device),
``abstract_decode_state`` (each leaf by path against ``jax.eval_shape`` of
the reference's, all on ``meta``), and ``param_count``,
``active_param_count``, ``model_flops`` and ``attention_flops`` (without
and with the causal skip), exactly equal."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPE_CELLS as JCELLS
from repro.configs import cell_supported as jcell_supported
from repro.configs import input_specs as jinput_specs
from repro.models import api as japi
from repro.models import flops as jflops

from repro_torch.configs import ARCHS, SHAPE_CELLS, cell_supported, input_specs
from repro_torch.models import api as tapi
from repro_torch.models import flops as tflops

PAIRS = [(a, c) for a in ARCHS for c in SHAPE_CELLS]
_NP = {torch.int32: "int32", torch.bfloat16: "bfloat16",
       torch.float32: "float32", torch.int64: "int64", torch.bool: "bool"}


def _dtype(t) -> str:
    return _NP[t]


def test_shape_cells_are_the_reference_cells():
    assert list(SHAPE_CELLS) == list(JCELLS)
    for name, cell in SHAPE_CELLS.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(JCELLS[name])
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch,cell", PAIRS, ids=[f"{a}-{c}" for a, c in PAIRS])
def test_cell_inputs_state_and_counts_equal_the_reference(arch, cell):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    c, jc = SHAPE_CELLS[cell], JCELLS[cell]
    assert cfg.sub_quadratic() == jcfg.sub_quadratic()
    assert cell_supported(cfg, c) == jcell_supported(jcfg, jc)

    got, want = input_specs(cfg, c), jinput_specs(jcfg, jc)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert _dtype(got[k].dtype) == np.dtype(v.dtype).name, k

    state = tapi.abstract_decode_state(cfg, c)
    ref = jax.eval_shape(lambda: japi.init_decode_state(
        jcfg, jc.global_batch, jc.seq_len))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(state) == sorted(flat)
    for k, v in flat.items():
        assert state[k].device.type == "meta", k
        assert tuple(state[k].shape) == tuple(v.shape), k
        assert _dtype(state[k].dtype) == np.dtype(v.dtype).name, k

    assert tflops.param_count(cfg) == jflops.param_count(jcfg)
    assert tflops.active_param_count(cfg) == jflops.active_param_count(jcfg)
    assert tflops.model_flops(cfg, c) == jflops.model_flops(jcfg, jc)
    for skip in (False, True):
        assert tflops.attention_flops(cfg, c, causal_skip=skip) == \
            jflops.attention_flops(jcfg, jc, causal_skip=skip)


def test_published_counts():
    """Two of the reference's figures: olmo-1b's 1.18 B parameters and
    mixtral-8x22b's train_4k MODEL_FLOPS."""
    assert round(tflops.param_count(ARCHS["olmo-1b"]) / 1e9, 2) == 1.18
    assert f"{tflops.model_flops(ARCHS['mixtral-8x22b'], SHAPE_CELLS['train_4k']):.3e}" \
        == "2.451e+17"


def test_abstract_decode_state_allocates_nothing():
    """decode_32k holds ~550 GB of olmo-1b KV cache: every leaf is meta."""
    state = tapi.abstract_decode_state(ARCHS["olmo-1b"], SHAPE_CELLS["decode_32k"])
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    assert nbytes > 500e9
    assert all(t.device.type == "meta" for t in state.values())


@pytest.mark.parametrize("fn", ["train_loss", "prefill", "decode"])
def test_unroll_is_accepted_and_changes_nothing(fn):
    """The reference's ``unroll=`` keyword: the eager port has no scan to
    unroll, so the outputs are bitwise the same with it on and off."""
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.data.synthetic import MarkovLM

    cfg = reduced_config(get_arch("olmo-1b"), vocab=64)
    params = tapi.init_params(0, cfg, "cpu")
    b = MarkovLM(vocab=64, k=4, seed=0).batch(2, 8, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    outs = []
    for unroll in (False, True):
        with torch.no_grad():
            if fn == "train_loss":
                outs.append(tapi.train_loss(params, cfg, batch, unroll=unroll))
            elif fn == "prefill":
                outs.append(tapi.prefill(params, cfg, batch, unroll=unroll)[0])
            else:
                state = tapi.init_decode_state(cfg, 2, 16, device="cpu")
                outs.append(tapi.decode(params, cfg, state,
                                        batch["tokens"][:, :1],
                                        torch.tensor([0, 0]), unroll=unroll)[0])
    assert torch.equal(outs[0], outs[1])


def test_make_train_step_accepts_unroll():
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.optim.optimizers import sgd
    from repro_torch.training.trainer import init_train_state, make_train_step

    cfg = reduced_config(get_arch("olmo-1b"), vocab=64)
    b = MarkovLM(vocab=64, k=4, seed=0).batch(2, 8, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    losses = []
    for unroll in (False, True):
        opt = sgd(0.9)
        state = init_train_state(0, cfg, opt, device="cpu")
        step = make_train_step(cfg, opt, lr=0.1, unroll=unroll)
        for _ in range(2):
            state, m = step(state, batch)
        losses.append((float(m["loss"]), state.params["embed"].clone()))
    assert losses[0][0] == losses[1][0]
    assert torch.equal(losses[0][1], losses[1][1])
