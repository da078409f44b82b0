"""The pool is made from --seed alone: the same seed gives the same pairs,
another seed other arrays of the same pairs."""
import json
import os

import numpy as np
import pytest
import torch

from benchlib import pool as P
from conftest import ROOT

BIG = 2 ** 33 + 17   # seeds pass 32 bits


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(ROOT, "benchmark/configs/dot2d_129x33.json")) as f:
        return json.load(f)


def test_same_seed_same_pool(config):
    a = P.make_pool(config, BIG, "cpu", ROOT)
    b = P.make_pool(config, BIG, "cpu", ROOT)
    assert len(a) == config["pool"]["size"] == 16
    for (x0, x1), (y0, y1) in zip(a, b):
        assert torch.equal(x0, y0) and torch.equal(x1, y1)


def test_pairs_are_unit_mean_float32_densities(config):
    for r0, r1 in P.make_pool(config, BIG, "cpu", ROOT):
        for r in (r0, r1):
            assert r.dtype == torch.float32 and r.shape == (129, 129)
            assert float(r.min()) > 0.0
            assert abs(float(r.double().mean()) - 1.0) < 1e-6


def test_other_seed_turns_the_same_pairs(config):
    a = P.make_pool(config, BIG, "cpu", ROOT)
    b = P.make_pool(config, BIG + 1, "cpu", ROOT)
    oa, ob = P.orientations(BIG, 16), P.orientations(BIG + 1, 16)
    assert oa != ob
    for (x0, _), (y0, _) in zip(a, b):
        # the same values, in another arrangement where the symmetry differs
        assert torch.equal(torch.sort(x0.flatten())[0],
                           torch.sort(y0.flatten())[0])
    assert any(not torch.equal(x0, y0) for (x0, _), (y0, _) in zip(a, b))


def test_stitch_slots_hold_the_demo_pair(config):
    pool = P.make_pool(config, BIG, "cpu", ROOT)
    s0, _ = P.stitch_pair(ROOT, config["pool"]["stitch"])
    o = P.orientations(BIG, 16)
    for slot in config["pool"]["stitch"]["slots"]:
        want = P._orient(torch.as_tensor(s0), o[slot]).float()
        assert torch.equal(pool[slot][0], want)


def test_cauchy_parameters_are_fixed_by_the_pool_seed(config):
    spec = config["pool"]["cauchy"]
    a, b = P.cauchy_params(spec, 3), P.cauchy_params(spec, 3)
    for (wa, ca, sa), (wb, cb, sb) in zip(a, b):
        assert np.array_equal(wa, wb) and np.array_equal(ca, cb)
        assert spec["bumps"][0] <= len(wa) <= spec["bumps"][1]


@pytest.fixture(scope="module")
def config513():
    with open(os.path.join(ROOT, "benchmark/configs/dot2d_513x65.json")) as f:
        return json.load(f)


def test_pool_without_cauchy_block_holds_the_stitch_pair(config513):
    """16 copies of the stitch pair, each turned by its slot's symmetry."""
    assert "cauchy" not in config513["pool"]
    assert P.slot_pairs(config513) == ["stitch"] * 16
    assert set(P.pairs(config513, "cpu", ROOT)) == {"stitch"}
    pool = P.make_pool(config513, BIG, "cpu", ROOT)
    o = P.orientations(BIG, 16)
    pair = P.stitch_pair(ROOT, config513["pool"]["stitch"])
    assert len(pool) == 16
    for slot, (r0, r1) in enumerate(pool):
        for r, s in ((r0, pair[0]), (r1, pair[1])):
            assert r.dtype == torch.float32 and r.shape == (513, 513)
            assert torch.equal(r, P._orient(torch.as_tensor(s), o[slot])
                               .float())


def test_slots_without_a_pair_are_refused(config513):
    bad = dict(config513, pool=dict(config513["pool"], stitch=dict(
        config513["pool"]["stitch"], slots=[0, 1])))
    with pytest.raises(ValueError, match="no cauchy block"):
        P.slot_pairs(bad)
