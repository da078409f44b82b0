"""A whole run on the CPU, past the harness's look for a card, with the
program broken underneath: ``correct`` comes out false for each fault the
cell can have. (A stream solves one instance a call, so no batch can be
half left out, and every cell runs on one card, so there is no exchange
between chips to leave out.)"""
import torch

from benchlib import cell, manifest
from conftest import ROOT
from dotsocp_tpu_torch.algorithms.core import Kernels
from dotsocp_tpu_torch.multilevel import solve as solve_mod

STREAM = "dotmark129_stream"


def _run(tiny_manifest, seconds=0.3, opts=None):
    spec = manifest.cell(ROOT, STREAM, manifest=tiny_manifest)
    if opts:
        spec["traffic"] = dict(spec["traffic"], opts=opts)
    torch.manual_seed(0)
    res, _ = cell.run(ROOT, STREAM, 2 ** 40 + 3, seconds, False,
                      device="cpu", spec=spec)
    return res


def test_sound_run_is_correct(tiny_manifest):
    res = _run(tiny_manifest)
    assert res["correct"] is True, res["checks"]


def test_step_that_returns_its_state_unchanged(tiny_manifest, monkeypatch):
    monkeypatch.setattr(Kernels, "_step", lambda self, s: s)
    monkeypatch.setattr(Kernels, "segment_impl", lambda self, s, k: s)
    # a broken step never converges: keep its loop short
    res = _run(tiny_manifest, opts={"maxit": 60})
    assert res["correct"] is False, res["checks"]


def test_answer_altered_where_it_is_produced(tiny_manifest, monkeypatch):
    """An interior slab of the density answered one time step late."""
    real = solve_mod.solve_dot

    def late(*a, **kw):
        out, h, last = real(*a, **kw)
        rho = out["rho"].clone()
        rho[2:-1] = out["rho"][1:-2]
        return dict(out, rho=rho), h, last

    monkeypatch.setattr(solve_mod, "solve_dot", late)
    res = _run(tiny_manifest)
    assert res["correct"] is False, res["checks"]


def test_answer_to_a_stalled_solve(tiny_manifest):
    """A solve cut short of its tolerance (60 iterations a level): feasible
    in its averages as far as it got, and far from the optimum."""
    res = _run(tiny_manifest, opts={"maxit": 60})
    assert res["correct"] is False, res["checks"]
