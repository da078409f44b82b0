"""The demos of the PyTorch port (``dotsocp_tpu_torch/demos/``) on the CPU
at small sizes: each ``main([..., "--cpu"])`` returns a solve whose mass is
conserved and whose final KKT is below its tolerance; ``--plot`` and
``--export`` write their files through the port's viz; ``demo_batch --mode
sharded`` raises; without ``--cpu`` a demo runs on the card and, where
there is none, raises instead of falling back to the CPU; and a demo
without ``--plot`` imports neither matplotlib nor PIL."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.demos import (demo_batch, demo_dot1d, demo_dot2d,
                                     demo_dot3d, demo_wdot2d)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _stop(h, weighted=False):
    return float(np.max(np.asarray(h["kkt"][-1])[[0, 2, 5] if weighted
                                                 else [0, 2, 5, 6]]))


@pytest.mark.parametrize("demo,argv,tol,weighted", [
    (demo_dot1d, ["--nx", "65", "--nt", "9", "--levels", "2", "--tol",
                  "1e-4"], 1e-4, False),
    (demo_dot1d, ["--nx", "65", "--nt", "9", "--levels", "2", "--tol",
                  "1e-5", "--mixed"], 1e-5, False),
    (demo_dot2d, ["--nx", "33", "--nt", "9", "--levels", "2"], 1e-4, False),
    (demo_dot2d, ["--nx", "33", "--nt", "9", "--levels", "2", "--problem",
                  "example5", "--f64"], 1e-4, False),
    (demo_dot3d, ["--n", "9", "--nt", "5", "--levels", "2"], 1e-4, False),
    (demo_wdot2d, ["--nx", "33", "--nt", "9", "--levels", "2", "--problem",
                   "maze14", "--barrier", "maze14", "--f64"], 1e-3, True),
    (demo_wdot2d, ["--nx", "17", "--nt", "9", "--levels", "1", "--barrier",
                   "example6", "--problem", "example6"], 1e-3, True),
], ids=["dot1d", "dot1d-mixed", "dot2d-dotmark", "dot2d-example5", "dot3d",
        "wdot2d-maze14", "wdot2d-example6"])
def test_demo_conserves_mass_and_converges(demo, argv, tol, weighted, capsys):
    out, _, h = demo.main(argv + ["--cpu"])
    assert out["mass_ok"]
    assert _stop(h, weighted) < tol
    printed = capsys.readouterr().out
    assert "Mass conservation: OK" in printed and "Final KKT:" in printed
    want = torch.float64 if ("--f64" in argv or demo is demo_dot1d) \
        else torch.float32
    assert out["rho"].dtype == want and out["rho"].device.type == "cpu"


@pytest.mark.parametrize("mode", ["lockstep", "sequential", "auto"])
def test_demo_batch(mode, capsys):
    out = demo_batch.main(["--cpu", "--batch", "2", "--nx", "17", "--nt",
                           "5", "--levels", "2", "--mode", mode])
    assert out["mass_ok"] and bool(np.all(out["done"]))
    assert out["mode"] == ("lockstep" if mode == "auto" else mode)
    assert float(np.asarray(out["kkt"])[:, [0, 2, 5, 6]].max()) < 1e-4
    assert "Mass conservation: OK" in capsys.readouterr().out


def test_demo_batch_sharded_raises():
    """A world of one rank has no batch axis to split (the spawned run is
    ``tests/test_torch_parallel.py``'s)."""
    with pytest.raises(ValueError, match="two ranks"):
        demo_batch.main(["--cpu", "--mode", "sharded"])


def test_demo_plots_and_export(tmp_path):
    p1 = str(tmp_path / "evo1d.png")
    demo_dot1d.main(["--cpu", "--nx", "33", "--nt", "5", "--levels", "1",
                     "--tol", "1e-3", "--plot", p1])
    p2, gif = str(tmp_path / "evo2d.png"), str(tmp_path / "evo2d.gif")
    demo_dot2d.main(["--cpu", "--nx", "17", "--nt", "5", "--levels", "1",
                     "--problem", "example2", "--tol", "1e-3", "--plot", p2,
                     "--export", gif])
    p3 = str(tmp_path / "evo3d.png")
    demo_dot3d.main(["--cpu", "--n", "9", "--nt", "5", "--levels", "1",
                     "--tol", "1e-3", "--plot", p3])
    p4 = str(tmp_path / "evow.png")
    demo_wdot2d.main(["--cpu", "--nx", "17", "--nt", "5", "--levels", "1",
                      "--plot", p4])
    for path in (p1, p2, gif, p3, p4):
        assert os.path.getsize(path) > 0, path


@pytest.mark.parametrize("demo", [demo_dot1d, demo_dot2d, demo_dot3d,
                                  demo_wdot2d, demo_batch])
def test_demo_runs_on_the_card_unless_asked(demo, monkeypatch):
    """Without ``--cpu`` the solve is asked for the card: ``solve_dot`` /
    ``solve_fleet`` get ``device="cuda"``, and so does the weight."""
    from dotsocp_tpu_torch.models import wdot2d
    from dotsocp_tpu_torch.multilevel import solve
    from dotsocp_tpu_torch.parallel import batch

    seen = []

    def record(*args, **kw):
        seen.append(kw.get("device"))
        raise RuntimeError("stop here")

    def weight(*args, **kw):
        seen.append(kw.get("device"))

    monkeypatch.setattr(solve, "solve_dot", record)
    monkeypatch.setattr(batch, "solve_fleet", record)
    monkeypatch.setattr(wdot2d, "get_weight_by_barrier", weight)
    with pytest.raises(RuntimeError, match="stop here"):
        demo.main(["--levels", "1"])
    assert seen == ["cuda"] * (2 if demo is demo_wdot2d else 1)


def test_demo_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the demo would run on it")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        demo_dot2d.main(["--nx", "17", "--nt", "5", "--levels", "1",
                         "--problem", "example2"])


def test_demo_needs_neither_matplotlib_nor_pil():
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import dotsocp_tpu_torch\n"
        "from dotsocp_tpu_torch.demos import demo_dot2d, demo_wdot2d\n"
        "out, _, _ = demo_dot2d.main(['--cpu', '--nx', '33', '--nt', '5',\n"
        "    '--levels', '1', '--problem', 'example5', '--tol', '1e-3'])\n"
        "assert out['mass_ok']\n"
        "out, _, _ = demo_wdot2d.main(['--cpu', '--nx', '17', '--nt', '5',\n"
        "    '--levels', '1', '--problem', 'maze14', '--barrier', 'maze14'])\n"
        "assert out['mass_ok']\n"
        "print('NO-MPL-NO-PIL OK')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO-MPL-NO-PIL OK" in res.stdout
