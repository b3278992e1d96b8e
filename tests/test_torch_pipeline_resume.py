"""The durable slice cache and resumable runs of the port's pipeline: the
reference's ``test_cache_persists_across_runs``,
``test_resume_refuses_mismatched_weights``, ``test_resume_reuses_manifest_plans``
and ``test_resume_after_sigkill_matches_uninterrupted`` on the port's
``run_pipeline`` and ``python -m repro_torch.launch.compress --arch olmo-1b
--quickstart --device cpu --workers 2``; the cache files and the run
manifest each package writes are read by the other (the cache files byte for
byte the same); a torn entry is a miss and is overwritten; the other resume
refusals."""
import json
import os
import signal
import subprocess
import sys
import time

import msgpack
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.pipeline import cache as jcache
from repro.pipeline import run_pipeline as jrun
from repro.pipeline import runner as jrunner
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.core import compress as tc
from repro_torch.core.artifact import CompressedModel
from repro_torch.pipeline import cache as tcache
from repro_torch.pipeline import run_pipeline as trun
from repro_torch.pipeline import runner as trunner

from test_torch_compress import assert_dense_equal, report_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _units(pkg, n_dense=3, seed=0, shape=(40, 20)):
    rng = np.random.default_rng(seed)
    return [pkg.CompressibleDense(name=f"d{i}", weight=rng.standard_normal(shape))
            for i in range(n_dense)]


def _cfg(pkg, **kw):
    return pkg.CompressionConfig(**{"algorithm": "fp", "weight_sharing": True,
                                    "max_share_rel_err": 0.06, **kw})


def _assert_records_bitwise(ra, rb):
    assert list(ra) == list(rb)
    for n in ra:
        assert_dense_equal(ra[n], rb[n])


def test_cache_persists_across_runs(tmp_path):
    units = _units(tc)
    cache = str(tmp_path / "cache")
    cold = trun(units, _cfg(tc), n_workers=1, cache_dir=cache)
    warm = trun(units, _cfg(tc), n_workers=2, cache_dir=cache)
    assert cold.stats["cache_hits"] == 0
    assert warm.stats["cache_misses"] == 0
    assert warm.stats["cache_hits"] == warm.stats["jobs"]
    _assert_records_bitwise(cold.records, warm.records)
    assert report_rows(cold.report) == report_rows(warm.report)
    assert len(tcache.SliceCache(cache)) == cold.stats["jobs"]


def test_cache_files_are_the_references_byte_for_byte(tmp_path):
    """Each package's entries for the same jobs: the same names and bytes;
    the reference's ``piece_from_tree`` reads the port's, and the port's
    run is all hits on the reference's cache."""
    jrun(_units(jc), _cfg(jc), n_workers=1, cache_dir=str(tmp_path / "ref"))
    trun(_units(tc), _cfg(tc), n_workers=1, cache_dir=str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names and sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        blob = (tmp_path / "port" / n).read_bytes()
        assert blob == (tmp_path / "ref" / n).read_bytes(), n
        piece = jcache.piece_from_tree(msgpack.unpackb(blob, raw=False))
        mine = tcache.piece_from_tree(tcache.msgpack_codec.unpackb(blob))
        assert piece.to_dense().tobytes() == mine.to_dense().tobytes()
    warm = trun(_units(tc), _cfg(tc), n_workers=1, cache_dir=str(tmp_path / "ref"))
    assert warm.stats["cache_misses"] == 0


def test_a_torn_entry_is_a_miss_and_is_overwritten(tmp_path):
    cache_dir = str(tmp_path / "cache")
    cold = trun(_units(tc, n_dense=1), _cfg(tc), cache_dir=cache_dir)
    names = sorted(os.listdir(cache_dir))
    torn = tmp_path / "cache" / names[0]
    good = torn.read_bytes()
    torn.write_bytes(good[: len(good) // 2])
    corrupt = tmp_path / "cache" / names[1]
    raw = bytearray(corrupt.read_bytes())
    raw[-3] ^= 0xFF  # inside the last leaf's data: its crc fails
    corrupt.write_bytes(bytes(raw))
    again = trun(_units(tc, n_dense=1), _cfg(tc), cache_dir=cache_dir)
    assert again.stats["cache_misses"] == 2
    assert again.stats["cache_hits"] == cold.stats["jobs"] - 2
    assert torn.read_bytes() == good
    _assert_records_bitwise(cold.records, again.records)


def test_resume_refuses_mismatched_weights(tmp_path):
    units = _units(tc, n_dense=2, seed=4)
    run_dir = str(tmp_path / "run")
    trun(units, _cfg(tc), n_workers=1, run_dir=run_dir)
    other = _units(tc, n_dense=2, seed=5)
    with pytest.raises(ValueError, match="hash"):
        trun(other, _cfg(tc), n_workers=1, run_dir=run_dir, resume=True)


@pytest.mark.parametrize("change,match", [
    ({"units": 3}, "unit list"), ({"cfg": {"s_terms": 3}}, "compression config"),
    ({"budget": 10 ** 9}, "budget"), ({"sub": 2}, "conv_channel_subsample")],
    ids=["units", "config", "budget", "subsample"])
def test_resume_refuses_another_run(tmp_path, change, match):
    run_dir = str(tmp_path / "run")
    trun(_units(tc, n_dense=2), _cfg(tc), run_dir=run_dir)
    with pytest.raises(ValueError, match=match):
        trun(_units(tc, n_dense=change.get("units", 2)),
             _cfg(tc, **change.get("cfg", {})), run_dir=run_dir, resume=True,
             budget_adds=change.get("budget"),
             conv_channel_subsample=change.get("sub"))


def test_resume_reuses_manifest_plans(tmp_path):
    units = _units(tc, n_dense=3, seed=6)
    run_dir = str(tmp_path / "run")
    first = trun(units, _cfg(tc), n_workers=1, run_dir=run_dir)
    assert os.path.isdir(os.path.join(run_dir, "slice_cache"))  # beside it
    events = []
    second = trun(units, _cfg(tc), n_workers=1, run_dir=run_dir,
                  resume=True, progress=events.append)
    assert any(e.kind == "resume" for e in events)
    assert second.stats["cache_misses"] == 0  # every slice from the cache
    assert second.budget_info == {"budget_adds": None, "resumed": True}
    _assert_records_bitwise(first.records, second.records)


def test_manifests_are_read_by_either_package(tmp_path):
    trun(_units(tc), _cfg(tc), run_dir=str(tmp_path / "port"))
    jrun(_units(jc), _cfg(jc), run_dir=str(tmp_path / "ref"))
    mine = trunner._load_manifest(str(tmp_path / "ref"))
    assert mine == jrunner._load_manifest(str(tmp_path / "port"))
    assert mine["units"] == ["d0", "d1", "d2"]
    # the reference resumes a run the port recorded
    res = jrun(_units(jc), _cfg(jc), run_dir=str(tmp_path / "port"), resume=True)
    assert res.budget_info["resumed"] and res.stats["cache_misses"] == 0


# ----------------------------------------------------- SIGKILL + resume


def _cli_cmd(out_dir, *extra):
    return [sys.executable, "-m", "repro_torch.launch.compress", "--arch",
            "olmo-1b", "--quickstart", "--device", "cpu", "--workers", "2",
            "--seed", "0", "--quiet", "--out", str(out_dir), *extra]


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def test_resume_after_sigkill_matches_uninterrupted(tmp_path):
    """SIGKILL the compress launcher mid-way, resume it, and require the
    artifact to be bitwise-identical to an uninterrupted run."""
    killed_dir = tmp_path / "killed"
    clean_dir = tmp_path / "clean"

    # start, wait until a few slice results are durably cached, SIGKILL
    # a session of its own: the kill takes the launcher, its forkserver and
    # its workers together, as a lost machine would
    proc = subprocess.Popen(_cli_cmd(killed_dir), env=_cli_env(), cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, start_new_session=True)
    cache = killed_dir / "cache"
    deadline = time.time() + 120
    killed = False
    while time.time() < deadline and proc.poll() is None:
        done = len(list(cache.glob("*.msgpack"))) if cache.exists() else 0
        if done >= 4:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            killed = True
            break
        time.sleep(0.01)
    assert killed, "run finished before it could be killed; enlarge the model"
    assert not (killed_dir / "artifact").exists()  # it really died mid-run

    # resume to completion; a fresh run is the reference
    r = subprocess.run(_cli_cmd(killed_dir, "--resume"), env=_cli_env(),
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    r2 = subprocess.run(_cli_cmd(clean_dir), env=_cli_env(), cwd=REPO,
                        capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr

    resumed = CompressedModel.load(str(killed_dir / "artifact"), device="cpu")
    clean = CompressedModel.load(str(clean_dir / "artifact"), device="cpu")
    _assert_records_bitwise(resumed.records, clean.records)
    assert report_rows(resumed.report) == report_rows(clean.report)
    # dense-effective params match bitwise too
    pa, pb = _flatten(resumed.params), _flatten(clean.params)
    assert list(pa) == list(pb) and len(pa) > 0
    for k, a in pa.items():
        assert torch.equal(a, pb[k]), k
    # the resumed run actually reused the killed run's work
    stats = json.loads((killed_dir / "stats.json").read_text())
    assert stats["cache_hits"] >= 4
    assert stats["jobs"] == json.loads((clean_dir / "stats.json").read_text())["jobs"]


def test_launcher_refusals(tmp_path):
    """The reference launcher's ``--metrics-out`` (refused until the
    telemetry was ported) writes the run's metrics."""
    from repro_torch.launch import compress

    out = tmp_path / "m.json"
    stats = compress.main(["--device", "cpu", "--out", str(tmp_path),
                           "--quiet", "--include", "ffn.down",
                           "--metrics-out", str(out)])
    metrics = json.loads(out.read_text())["metrics"]
    adds = {v["labels"]["stage"]: v["value"]
            for v in metrics["pipeline_adds"]["values"]}
    assert set(adds) == {"baseline", "lcc"} and adds["lcc"] < adds["baseline"]
    run = {v["labels"]["stat"]: v["value"]
           for v in metrics["pipeline_run"]["values"]}
    assert run["units"] == stats["units"] == 2


def test_launcher_resnet_small_is_no_longer_refused(tmp_path):
    """``--arch resnet-small`` compresses the reduced ResNet's conv units
    and its head (it was refused until the conv units were ported)."""
    from repro_torch.core.artifact import CompressedModel
    from repro_torch.launch import compress

    stats = compress.main(["--device", "cpu", "--out", str(tmp_path),
                           "--arch", "resnet-small", "--quiet",
                           "--include", "block0"])
    assert stats["units"] == 2
    art = CompressedModel.load(str(tmp_path / "artifact"), device="cpu")
    assert art.family == "resnet" and art.config.classes == 6
    assert sorted(art.records) == ["block0.conv1", "block0.conv2"]
