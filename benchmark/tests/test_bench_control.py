"""The control: the plain reference computed in TF32, put in the
program's place, comes out not correct under the cell's limits. The
readings that set the limits are taken on the card at the cell's size with
``control.py`` (PERF.md gives them); here the control runs at a size a
test run holds, and on the card at the cell's own size."""
import pytest

import control
from benchlib import cell, manifest
from conftest import ROOT


def _run(spec, device, seconds, monkeypatch, workload="dotmark129_stream"):
    control.reference_in_place(spec, "tf32", put=monkeypatch.setattr)
    return cell.run(ROOT, workload, 2 ** 35 + 11, seconds, False,
                    device=device, spec=spec, warmups=1)


def test_tf32_reference_in_the_programs_place(tiny_manifest, monkeypatch):
    spec = manifest.cell(ROOT, "dotmark129_stream", manifest=tiny_manifest)
    res, rec = _run(spec, "cpu", 0.1, monkeypatch)
    assert res["correct"] is False, res["checks"]
    assert not any(c.done[0] for c in rec.calls)


@pytest.mark.cuda
def test_tf32_reference_on_the_card_at_the_cells_size(card, monkeypatch):
    spec = manifest.cell(ROOT, "dotmark129_stream")
    res, _ = _run(spec, card, 3.0, monkeypatch)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_tf32_reference_on_the_card_at_the_513_cells_size(card, monkeypatch):
    """At 513^2 x 65 the control's solve is the TF32 reference itself
    (~85 s a call on the H100), judged through the table."""
    spec = manifest.cell(ROOT, "dotmark513_stream")
    res, _ = _run(spec, card, 1.0, monkeypatch, "dotmark513_stream")
    assert res["correct"] is False, res["checks"]
