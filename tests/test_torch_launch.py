"""The port's launchers (``repro_torch.launch.train``, ``.serve``) on the CPU:
each ``main()`` at a reduced config with ``--device cpu``, the reference's
CLI (each under a one-rank mesh), ``--production-mesh`` refused on a group
of other than 256 ranks, and neither
module importing JAX or the reference package."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b", "granite-3-8b"])
def test_train_main_runs_a_few_steps(arch, tmp_path, capsys):
    out = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                             "--seq", "32", "--warmup", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert int(out["state"]["step"]) == 3
    assert sorted(p.name for p in tmp_path.iterdir())  # checkpoints written
    assert f"[train] {arch}: 3 steps" in capsys.readouterr().out


def test_train_main_refuses_the_production_mesh():
    with pytest.raises(ValueError, match="needs 256 ranks, the process group has 1"):
        launch_train.main(["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu", "--production-mesh"])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b", "musicgen-large"])
def test_serve_main_answers_every_request(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                              "--prompt-len", "8", "--max-tokens", "4", "--max-len", "32"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.generated) == 4 for r in done)
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out


def test_launchers_import_no_jax():
    code = ("import sys; import repro_torch.launch.train, repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
