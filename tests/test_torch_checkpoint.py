"""The port's Checkpointer: the reference's cases (round trip, keep-last-k
GC, corruption detected and skipped, a partial write invisible, async save)
on tensor trees; flat names equal the reference's ``_flatten`` names on the
same (converted) ``TrainState`` of reduced olmo, and both packages write the
same shard byte for byte; a checkpoint of either package (bf16 leaves
included) reads bitwise through the other's ``restore_flat``; an async save
holds a copy of tensors the caller goes on updating in place; a writer
error surfaces at ``wait``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.optim import optimizers as jo
from repro.training import regularize as jreg
from repro.training import trainer as jtr

from repro_torch.checkpoint import checkpointer as tck
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch, reduced_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.training import trainer as ttr

SHARD = "shard_0.msgpack"


def _np_tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((8, 8)).astype(np.float32),
                       "b": rng.standard_normal(8)},
            "step": np.int32(7)}


def _jtree():
    t = _np_tree()
    return {"params": {"w": jnp.asarray(t["params"]["w"]),
                       "b": jnp.asarray(t["params"]["b"], jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def _tree():
    """The reference test's tree as tensors: float32, bfloat16, int32."""
    t = _np_tree()
    return {"params": {"w": torch.from_numpy(t["params"]["w"]),
                       "b": torch.from_numpy(t["params"]["b"]).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _shard(root, step):
    return os.path.join(str(root), f"step_{step:010d}", SHARD)


def test_round_trip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ck.save(3, tree, blocking=True)
    like = {"params": {"w": torch.zeros(8, 8), "b": torch.zeros(8, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    step, restored = ck.restore_latest(like)
    assert step == 3
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"], tree["params"]["b"])
    assert int(restored["step"]) == 7 and restored["step"].dtype == torch.int32
    # restored tensors are the caller's own (not views of the map)
    restored["params"]["w"].add_(1.0)


def test_keep_last_k_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    assert ck.all_steps() == [3, 4]


def test_corruption_detected_and_skipped(tmp_path, capsys):
    ck = Checkpointer(str(tmp_path), keep=5)
    tree = _tree()
    ck.save(1, tree, blocking=True)
    ck.save(2, tree, blocking=True)
    with open(_shard(tmp_path, 2), "r+b") as f:  # corrupt the newest shard
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    step, restored = ck.restore_latest(tree)
    assert step == 1  # fell back to the intact checkpoint
    assert restored is not None
    assert "step 2 unreadable" in capsys.readouterr().out
    with pytest.raises(IOError, match="crc"):
        ck.restore_flat(2)


def test_partial_write_invisible(tmp_path):
    """A dir without DONE (crash mid-write) must not count as a checkpoint."""
    ck = Checkpointer(str(tmp_path), keep=5)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009"))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000010.tmp"))
    assert ck.all_steps() == []
    step, _ = ck.restore_latest(_tree())
    assert step is None


def test_async_save_holds_a_copy(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    want = tree["params"]["w"].clone()
    ck.save(5, tree, blocking=False)
    tree["params"]["w"].add_(1.0)  # the trainer updates in place meanwhile
    ck.wait()
    assert ck.all_steps() == [5]
    assert torch.equal(ck.restore(5, tree)["params"]["w"], want)


def test_writer_error_surfaces_at_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tck.msgpack_codec, "pack", boom)
    ck.save(1, _tree(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.all_steps() == []
    ck.wait()  # reported once


def test_restore_refuses_a_leaf_of_another_shape(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    like = _tree()
    like["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, like)
    like = _tree()
    del like["params"]["w"]
    like["params"]["v"] = torch.zeros(8, 8)
    with pytest.raises(KeyError, match="params/v"):
        ck.restore(1, like)


def test_either_package_reads_the_others_checkpoint_bitwise(tmp_path):
    jck.Checkpointer(str(tmp_path / "ref")).save(3, _jtree(), blocking=True)
    Checkpointer(str(tmp_path / "port")).save(3, _tree(), blocking=True)
    with open(_shard(tmp_path / "ref", 3), "rb") as f:
        ref_bytes = f.read()
    with open(_shard(tmp_path / "port", 3), "rb") as f:
        assert f.read() == ref_bytes
    got = Checkpointer(str(tmp_path / "ref")).restore_flat(3)
    assert sorted(got) == ["params/b", "params/w", "step"]
    assert got["params/b"].dtype == torch.bfloat16
    assert torch.equal(got["params/b"], _tree()["params"]["b"])
    assert got["params/w"].tobytes() == _np_tree()["params"]["w"].tobytes()
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7
    back = jck.Checkpointer(str(tmp_path / "port")).restore_flat(3)
    assert back["params/b"].dtype == jnp.bfloat16
    assert (np.asarray(back["params/b"]).view(np.uint16).tobytes()
            == _tree()["params"]["b"].view(torch.int16).numpy().tobytes())
    assert back["params/w"].tobytes() == got["params/w"].tobytes()


def test_empty_leaves_save_byte_for_byte_as_the_reference(tmp_path):
    """A leaf with a zero in its shape (an FS program without nodes is
    ``[0, 6]``; a budgeted compression writes one) saves as the reference's
    and reads back in both packages."""
    tree = {"nodes": np.zeros((0, 6), np.int64),
            "w": np.zeros((3, 0), np.float32), "x": np.arange(4.0)}
    jck.Checkpointer(str(tmp_path / "ref")).save(0, tree, blocking=True)
    Checkpointer(str(tmp_path / "port")).save(0, tree, blocking=True)
    with open(_shard(tmp_path / "ref", 0), "rb") as f:
        ref_bytes = f.read()
    with open(_shard(tmp_path / "port", 0), "rb") as f:
        assert f.read() == ref_bytes
    got = Checkpointer(str(tmp_path / "ref")).restore_flat(0)
    assert got["nodes"].shape == (0, 6) and got["nodes"].dtype == np.int64
    assert got["w"].shape == (3, 0)
    back = jck.Checkpointer(str(tmp_path / "port")).restore_flat(0)
    assert np.asarray(back["nodes"]).shape == (0, 6)


def test_train_state_flat_names_and_shard_equal_the_reference(tmp_path):
    """Reduced olmo under ProxSGD (``mu``, the sparsity report), error_fb
    None: the same leaf names in the same order, the same shard bytes."""
    jcfg = jreduced(jget_arch("olmo-1b"), vocab=256)
    tcfg = reduced_config(get_arch("olmo-1b"), vocab=256)
    from repro.models import api as japi
    specs = jreg.site_group_specs(japi.abstract_params(jcfg), jcfg, 0.1)
    js = jtr.init_train_state(jax.random.PRNGKey(0), jcfg,
                              jo.prox_sgd(momentum=0.9, specs=specs),
                              prox_specs=specs)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg, "cpu")
    assert js.error_fb is None and ts.error_fb is None
    jnames = list(jck._flatten(js)[0])
    assert list(tck._flatten(ts)) == jnames
    assert jnames[0].startswith(".params/") and ".step" in jnames
    assert any(n.startswith(".prox_report/") for n in jnames)
    jck.Checkpointer(str(tmp_path / "ref")).save(0, js, blocking=True)
    Checkpointer(str(tmp_path / "port")).save(0, ts, blocking=True)
    with open(_shard(tmp_path / "ref", 0), "rb") as a, \
            open(_shard(tmp_path / "port", 0), "rb") as b:
        assert a.read() == b.read()
    # and the reference's checkpoint restores into the port's state
    like = ttr.TrainState(**{k: getattr(ts, k) for k in
                             ("params", "opt_state", "step", "prox_report")})
    step, back = Checkpointer(str(tmp_path / "ref")).restore_latest(like)
    assert step == 0
    for name, leaf in tck._flatten(back).items():
        assert torch.equal(leaf, tck._flatten(ts)[name]), name


def test_train_state_with_residuals_saves_as_the_reference(tmp_path):
    """A reference state with gradient-compression residuals (``error_fb``
    float32 ``[2, ...]``, the reference's default pod count) converts,
    saves byte for byte as the reference's shard, and each package restores
    the other's checkpoint into its own state bit for bit."""
    jcfg = jreduced(jget_arch("olmo-1b"), vocab=256)
    tcfg = reduced_config(get_arch("olmo-1b"), vocab=256)
    js = jtr.init_train_state(jax.random.PRNGKey(1), jcfg,
                              jo.adamw(weight_decay=0.01),
                              grad_compression=True)
    rng = np.random.default_rng(0)
    js = jtr.TrainState(  # residuals that are not all zeros
        params=js.params, opt_state=js.opt_state, step=js.step,
        error_fb=jax.tree.map(lambda e: jnp.asarray(
            rng.standard_normal(e.shape), jnp.float32), js.error_fb))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg, "cpu")
    leaves = jax.tree_util.tree_leaves(ts.error_fb)
    assert leaves and all(t.dtype == torch.float32 and t.shape[0] == 2
                          for t in leaves)
    jnames = list(jck._flatten(js)[0])
    assert list(tck._flatten(ts)) == jnames
    assert any(n.startswith(".error_fb/") for n in jnames)
    jck.Checkpointer(str(tmp_path / "ref")).save(5, js, blocking=True)
    Checkpointer(str(tmp_path / "port")).save(5, ts, blocking=True)
    with open(_shard(tmp_path / "ref", 5), "rb") as a, \
            open(_shard(tmp_path / "port", 5), "rb") as b:
        assert a.read() == b.read()
    step, back = Checkpointer(str(tmp_path / "ref")).restore_latest(ts)
    assert step == 5
    for name, leaf in tck._flatten(back).items():
        assert torch.equal(leaf, tck._flatten(ts)[name]), name
    jstep, jback = jck.Checkpointer(str(tmp_path / "port")).restore_latest(js)
    assert jstep == 5
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(jback)[0],
                         jax.tree_util.tree_leaves(js)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), p
