"""The three launchers on the recurrent families at reduced widths on the
CPU: ``launch/serve.py --arch rwkv6-1.6b`` / ``--arch zamba2-7b --reduced
--kernel`` (every site of the seeded artifact routed, the plan refused
with ``family:ssm`` / ``family:hybrid``, every request finished),
``launch/compress.py --family ssm`` / ``--family hybrid`` (the quickstart
widths, the family check passing, every site compressed and the artifact
written; the wrong family refused), and a few prox steps of
``launch/train.py --arch zamba2-7b`` (finite losses, the site-derived
groups of the hybrid's mamba projections and shared block)."""
import math

import pytest

from repro_torch.launch import compress as compress_launch
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch

FAMILY = {"rwkv6-1.6b": "ssm", "zamba2-7b": "hybrid"}


@pytest.mark.parametrize("arch", sorted(FAMILY))
def test_serve_launcher_serves_the_family(arch, capsys):
    serve_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--kernel", "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("-> [") == 2 and "[error" not in out
    routed = next(ln for ln in out.splitlines() if ln.startswith("routed "))
    n, total = routed.split()[1].split("/")
    assert n == total and int(n) > 0
    assert f"plan fallbacks {{'step': 'family:{FAMILY[arch]}'}}" in routed


@pytest.mark.parametrize("arch", sorted(FAMILY))
def test_compress_launcher_checks_the_family(arch, tmp_path, capsys):
    stats = compress_launch.main(["--arch", arch, "--device", "cpu",
                                  "--workers", "1", "--family", FAMILY[arch],
                                  "--out", str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert f"family={FAMILY[arch]}" in out
    assert stats["units"] > 0 and (tmp_path / "c" / "artifact").is_dir()
    other = "hybrid" if FAMILY[arch] == "ssm" else "ssm"
    with pytest.raises(SystemExit, match=f"--family {other}"):
        compress_launch.main(["--arch", arch, "--device", "cpu",
                              "--family", other, "--out", str(tmp_path / "d")])


def test_train_launcher_takes_prox_steps_on_the_hybrid(capsys):
    res = train_launch.main(["--arch", "zamba2-7b", "--device", "cpu",
                             "--prox", "--steps", "3", "--seq", "32"])
    assert res["arch"] == "zamba2-7b" and res["steps"] == 3
    assert math.isfinite(res["loss"])
    out = capsys.readouterr().out
    n_specs = int(out.split("[prox] ")[1].split()[0])
    # the mamba in/out projections of 4 layers and the shared block's 7
    assert n_specs == 2 + 7
