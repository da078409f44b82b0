"""The judge's table of optimum energies (``tabulate_energies.py``), at
33^2 x 9 on the CPU: the energy of the optimum is the same under the
square's eight symmetries, the table path judges a sound answer as the live
reference solve does, and the faults of the program still fail through it."""
import hashlib
import json
import os

import pytest
import torch

import control
import tabulate_energies
from benchlib import cell, dotmark, manifest, pool as P, reference as R
from conftest import FIXTURES, ROOT
from dotsocp_tpu_torch.algorithms.core import Kernels
from dotsocp_tpu_torch.multilevel import solve as solve_mod

STREAM = "dotmark129_stream"
SEED = 2 ** 40 + 3
_SOLVED = {}
_solve = R.solve


def _memo_solve(r0, r1, nt, **kw):
    """The reference solve, once for each input: the live path's solves
    are the ones the symmetry test made."""
    key = tuple(hashlib.sha256(torch.as_tensor(r).numpy().tobytes())
                .hexdigest() for r in (r0, r1)) + (nt,) + tuple(
        sorted((k, str(v)) for k, v in kw.items()))
    if key not in _SOLVED:
        _SOLVED[key] = _solve(r0, r1, nt, **kw)
    return _SOLVED[key]


def _no_solve(*a, **kw):
    raise AssertionError("the table path solved an instance")


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(FIXTURES, "tiny_stitch_33x9.json")) as f:
        return json.load(f)


def _ref_kw(config):
    rc = config["reference"]
    return dict(levels=int(rc["levels"]), tol=float(rc["tol"]),
                coarse_tol=float(rc["coarse_tol"]), maxit=int(rc["maxit"]),
                device=torch.device("cpu"))


@pytest.fixture(scope="module")
def by_symmetry(config):
    """The reference's solve of the stitch pair under each symmetry, as a
    pool slot holds it, at tol 1e-9."""
    base = P.pairs(config, "cpu", ROOT)["stitch"]
    return [_memo_solve(*(P._orient(r, o).to(torch.float32).contiguous()
                          for r in base), config["problem"]["nt"],
                        **_ref_kw(config)) for o in range(8)]


@pytest.fixture(scope="module")
def tabled(config, by_symmetry, tmp_path_factory):
    """The fixture configuration naming a table that
    ``tabulate_energies.py`` made."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "solve", _memo_solve)
        table = tabulate_energies.make_table(ROOT, config, "cpu", "test",
                                             "none")
    path = tmp_path_factory.mktemp("table") / "tiny.json"
    path.write_text(json.dumps(table))
    return dict(config, reference=dict(config["reference"], table=str(path)))


def test_energy_is_the_same_under_every_symmetry(by_symmetry):
    energies = [s.optimum().energy for s in by_symmetry]
    assert all(s.residual < 1e-9 for s in by_symmetry)
    assert max(energies) - min(energies) <= 1e-7 * energies[0], energies


def test_table_records_its_solve(tabled, by_symmetry):
    table = cell.read_table(ROOT, tabled)
    row = table["pairs"]["stitch"]
    assert set(table["pairs"]) == {"stitch"}
    assert row["energy"] == by_symmetry[0].optimum().energy
    assert row["residual"] == by_symmetry[0].residual
    assert row["iters"] == by_symmetry[0].iters and row["seconds"] >= 0.0
    assert table["command"] == "test" and table["card"] == "cpu"
    assert len(table["reference_sha256"]) == 64


def test_table_made_for_other_settings_is_refused(tabled):
    other = dict(tabled, reference=dict(tabled["reference"], tol=1e-6))
    with pytest.raises(ValueError, match="was made for"):
        cell.read_table(ROOT, other)


def test_table_made_by_another_reference_is_refused(tabled, tmp_path):
    table = cell.read_table(ROOT, tabled)
    assert table["reference_sha256"] == dotmark.reference_sha256()
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(dict(table, reference_sha256="0" * 64)))
    stale = dict(tabled, reference=dict(tabled["reference"],
                                        table=str(path)))
    with pytest.raises(ValueError, match="another"):
        cell.read_table(ROOT, stale)


def test_table_path_and_live_path_agree(tabled, monkeypatch, capsys):
    """A sound answer of three slots under three symmetries: the same
    continuity and energy_gap to 1e-6 relative by either path."""
    p = tabled["problem"]
    pool = P.make_pool(tabled, SEED, "cpu", ROOT)
    orient = P.orientations(SEED, len(pool))
    slots = [orient.index(o) for o in sorted(set(orient))[:3]]
    answers = []
    for s in slots:
        out, _, _ = solve_mod.solve_dot(
            *pool[s], p["nt"], p["levels"], {"tol": p["tol"]}, p["method"],
            device="cpu", dtype=torch.float32, verbose=False)
        answers.append((s, out["rho"], list(out["E"]), True))
    host = [tuple(x.cpu() for x in pr) for pr in pool]
    limits = {"continuity": 4e-4, "energy_gap": 3e-3}
    monkeypatch.setattr(R, "solve", _no_solve)
    capsys.readouterr()
    _, by_table, wrong, _ = cell.judge(tabled, limits, answers, host, "cpu",
                                       ROOT)
    assert "read, nothing solved" in capsys.readouterr().err
    monkeypatch.setattr(R, "solve", _memo_solve)
    live = dict(tabled, reference={k: v for k, v in
                                   tabled["reference"].items()
                                   if k != "table"})
    _, by_solve, _, _ = cell.judge(live, limits, answers, host, "cpu", ROOT)
    assert "solve(s)" in capsys.readouterr().err
    assert not wrong
    for name in limits:
        for a, b in zip(by_table[name], by_solve[name]):
            assert a == pytest.approx(b, rel=1e-6), name


def _run(tiny_manifest, config, seconds=0.3, opts=None, warmups=2,
         spec_hook=None):
    spec = manifest.cell(ROOT, STREAM, manifest=tiny_manifest)
    spec["config"] = config
    if opts:
        spec["traffic"] = dict(spec["traffic"], opts=opts)
    if spec_hook:
        spec_hook(spec)
    torch.manual_seed(0)
    res, _ = cell.run(ROOT, STREAM, SEED, seconds, False, device="cpu",
                      spec=spec, warmups=warmups)
    return res


def test_sound_run_is_correct_through_the_table(tiny_manifest, tabled,
                                                monkeypatch):
    monkeypatch.setattr(R, "solve", _no_solve)
    res = _run(tiny_manifest, tabled)
    assert res["correct"] is True, res["checks"]


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(Kernels, "_step", lambda self, s: s)
    monkeypatch.setattr(Kernels, "segment_impl", lambda self, s, k: s)
    return {"maxit": 60}


def _late_slab(monkeypatch):
    real = solve_mod.solve_dot

    def late(*a, **kw):
        out, h, last = real(*a, **kw)
        rho = out["rho"].clone()
        rho[2:-1] = out["rho"][1:-2]
        return dict(out, rho=rho), h, last

    monkeypatch.setattr(solve_mod, "solve_dot", late)
    return None


@pytest.mark.parametrize("fault", [
    _unchanged_step, _late_slab, lambda mp: {"maxit": 60}],
    ids=["step_returns_its_state", "slab_a_step_late", "cut_at_60_iters"])
def test_faults_fail_through_the_table(tiny_manifest, tabled, monkeypatch,
                                       fault):
    opts = fault(monkeypatch)
    monkeypatch.setattr(R, "solve", _no_solve)
    res = _run(tiny_manifest, tabled, opts=opts)
    assert res["correct"] is False, res["checks"]


def test_tf32_control_fails_through_the_table(tiny_manifest, tabled,
                                              monkeypatch):
    res = _run(tiny_manifest, tabled, seconds=0.1, warmups=1,
               spec_hook=lambda spec: control.reference_in_place(
                   spec, "tf32", put=monkeypatch.setattr))
    assert res["correct"] is False, res["checks"]
