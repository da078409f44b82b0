"""Checkpoint/resume of the port's device driver (``utils/checkpoint.py``,
``checkpoint_dir``), on the CPU in float64, as ``tests/test_checkpoint.py``
holds the JAX package's: a solve cut after one chunk and resumed from its
snapshot ends with the uninterrupted run's iterations and density; the
snapshot round trip and its ValueError; a stale snapshot (another level's
shapes) is ignored; an acc-ADMM snapshot carries the Halpern anchor, the
averaging counter and the iterate before the check. Under a mesh (a
spawned gloo world of two ranks, one file a rank) a resume matches the
uninterrupted run, and a stale file on one rank makes every rank start
afresh.
"""
import os

import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel.solve import solve_dot
from dotsocp_tpu_torch.parallel.launch import run_world
from dotsocp_tpu_torch.utils.checkpoint import load_tensors, save_tensors

from . import _torch_worlds as worlds

torch.set_num_threads(2)


def _solve(opts, method="inPALM", n=33, nt=9):
    r0, r1 = get_example_2d("example2", n, n)
    out, _, hist = solve_dot(r0, r1, nt, 1, dict(opts, driver="device"),
                             method, device="cpu", dtype=torch.float64,
                             verbose=False)
    return out, hist


@pytest.mark.parametrize("method,maxit,chunk", [("inPALM", 600, 200),
                                                ("acc-ADMM", 600, 300)])
def test_resume_matches_uninterrupted(tmp_path, method, maxit, chunk):
    """maxit 600 cut after one chunk; acc-ADMM's cut falls between two
    anchor restarts, so the snapshot carries a live anchor and counter."""
    base = {"tol": 1e-4, "maxit": maxit}
    full, h_full = _solve(base, method)
    ck = str(tmp_path / "ck")
    cut, _ = _solve(dict(base, checkpoint_dir=ck, chunk_iters=chunk,
                         max_chunks=1), method)
    assert cut["levels"][0]["iters"] == chunk
    assert cut["levels"][0]["iters"] < full["levels"][0]["iters"]
    assert os.path.exists(os.path.join(ck, "level1.npz"))
    res, h_res = _solve(dict(base, checkpoint_dir=ck, chunk_iters=chunk),
                        method)
    assert res["levels"][0]["iters"] == full["levels"][0]["iters"]
    np.testing.assert_array_equal(h_res["iter"], h_full["iter"])
    np.testing.assert_allclose(res["rho"].numpy(), full["rho"].numpy(),
                               rtol=1e-8, atol=1e-10)


def test_round_trip_and_mismatch(tmp_path):
    path = str(tmp_path / "t.npz")
    tensors = [torch.arange(5.0, dtype=torch.float64),
               torch.ones((2, 3), dtype=torch.float32),
               torch.tensor(7, dtype=torch.int32),
               torch.tensor(True)]
    save_tensors(path, tensors, {"k": 1})
    template = [torch.zeros_like(t) for t in tensors]
    back, meta = load_tensors(path, template)
    assert meta == {"k": 1}
    for got, want in zip(back, tensors):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # the template's dtype wins
    back, _ = load_tensors(path, [t.to(torch.float64) for t in template])
    assert back[1].dtype == torch.float64
    with pytest.raises(ValueError, match="shape"):
        load_tensors(path, [torch.zeros(6)] + template[1:])
    with pytest.raises(ValueError, match="number of tensors"):
        load_tensors(path, template[:3])
    with pytest.raises(ValueError, match="number of tensors"):
        load_tensors(path, template + [torch.zeros(1)])
    # the snapshot is written whole or not at all
    assert sorted(os.listdir(tmp_path)) == ["t.npz"]


def test_stale_checkpoint_is_ignored(tmp_path):
    """A snapshot of a 17^2 level in the place of a 33^2 level's: the solve
    runs from its start, as without one."""
    ck = str(tmp_path / "ck")
    _solve({"tol": 1e-4, "maxit": 100, "checkpoint_dir": ck}, n=17)
    assert os.path.exists(os.path.join(ck, "level1.npz"))
    want, h_want = _solve({"tol": 1e-4, "maxit": 300})
    got, h_got = _solve({"tol": 1e-4, "maxit": 300, "checkpoint_dir": ck})
    assert got["levels"][0]["iters"] == want["levels"][0]["iters"]
    np.testing.assert_array_equal(h_got["kkt"], h_want["kkt"])


def test_meshed_resume_agrees_across_ranks(tmp_path):
    """Two ranks on a (y,) mesh, maxit 300 cut in chunks of 100: a resume
    continues every rank from its own file; with the last rank's file put
    back one chunk, the ranks disagree and all start afresh (ending as
    the first cut did, not with blocks of two iterations); a resume to the
    end matches the uninterrupted run."""
    chunk = 100
    res = run_world(worlds.mesh_resume, 2, (str(tmp_path), 300, chunk),
                    timeout=300)
    for key in res[0]:
        assert res[1][key][0] == res[0][key][0]
        np.testing.assert_array_equal(res[1][key][1], res[0][key][1])
    r = res[0]
    assert (r["cut"][0], r["resumed_cut"][0], r["stale_cut"][0]) == \
        (chunk, 2 * chunk, chunk)
    np.testing.assert_array_equal(r["stale_cut"][1], r["cut"][1])
    assert r["resumed"][0] == r["full"][0] > 2 * chunk
    np.testing.assert_allclose(r["resumed"][1], r["full"][1], rtol=1e-8,
                               atol=1e-10)
