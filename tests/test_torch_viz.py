"""The viz layer of the PyTorch port (``dotsocp_tpu_torch/viz/plots.py``)
on the CPU with matplotlib's Agg backend: every plot renders and saves from
CPU tensors (and numpy), the export writes its frame series and its gif,
``violation_q`` equals the JAX function, and ``hist_positive_value``
differs from the JAX function exactly by the corrected scaling: the same
bins with the reference's fractions, not percentages, and both axes drawn
when no value is positive."""
import os

import numpy as np
import pytest
import torch

from dotsocp_tpu.viz import plots as jplots

from dotsocp_tpu_torch.viz import plots


def _fake_solution():
    nt, ny, nx = 5, 17, 17
    t = torch.linspace(0, 1, nt, dtype=torch.float64)[:, None, None]
    y = torch.linspace(0, 1, ny, dtype=torch.float64)[None, :, None]
    x = torch.linspace(0, 1, nx, dtype=torch.float64)[None, None, :]
    rho = torch.exp(-((x - 0.3 - 0.4 * t) ** 2 + (y - 0.5) ** 2) / 0.02)
    return rho, 0.4 * rho, torch.zeros_like(rho)


def test_all_plots_render_from_tensors(tmp_path):
    rho, Ex, Ey = _fake_solution()
    out = []

    def p(name):
        path = str(tmp_path / name)
        out.append(path)
        return path

    plots.show_evolution_1d(rho[:, 8, :], "join", save=p("e1j.png"))
    plots.show_evolution_1d(rho[:, 8, :], "tile", save=p("e1t.png"))
    for mode in ("imshow", "contourf", "contour", "contour3", "mesh"):
        plots.show_evolution_2d(rho, mode, save=p(f"e2{mode}.png"))
    mask = torch.zeros(rho.shape[1:], dtype=torch.bool)
    mask[5:8, 5:8] = True
    for mode in ("imshow", "contourf", "contour", "contour3"):
        plots.show_evolution_2d(rho, mode, barrier_mask=mask,
                                save=p(f"e2b_{mode}.png"))
    with pytest.raises(ValueError, match="mesh"):
        plots.show_evolution_2d(rho, "mesh", barrier_mask=mask)
    plots.show_evolution_3d(torch.rand(5, 7, 8, 9, generator=torch.Generator()
                                       .manual_seed(0)), save=p("e3.png"))
    plots.show_movement_2d(rho, Ex, Ey, barrier_mask=mask, save=p("mv.png"))
    kkt = torch.rand(20, 7, generator=torch.Generator().manual_seed(1)) * 1e-3
    plots.show_residual_curve(kkt, names=[f"k{i}" for i in range(7)],
                              x=torch.arange(20), save=p("rc.png"))
    plots.hist_negative_density(rho - 0.1, save=p("hn.png"))
    plots.hist_violation_q(rho[:-1], [Ex[:-1], Ey[:-1]], save=p("hv.png"))
    plots.hist_positive_value(rho - 0.1, save=p("hp.png"))
    plots.hist_positive_value(torch.zeros(8), save=p("hp0.png"))
    for path in out:
        assert os.path.exists(path) and os.path.getsize(path) > 0, path


def test_export_evolution_2d_from_tensors(tmp_path):
    rho, _, _ = _fake_solution()
    paths = plots.export_evolution_2d(rho, str(tmp_path / "ev.png"),
                                      num_frame=3, dpi=72)
    assert [os.path.basename(p) for p in paths] == [
        "ev-t=0.00.png", "ev-t=0.50.png", "ev-t=1.00.png"]
    mask = torch.zeros(rho.shape[1:], dtype=torch.bool)
    mask[2:4, 2:4] = True
    paths = plots.export_evolution_2d(rho, str(tmp_path / "ev.pdf"),
                                      num_frame=2, mode="contourf",
                                      barrier_mask=mask, colorbar=True,
                                      dpi=72)
    assert all(p.endswith(".pdf") and os.path.getsize(p) > 0 for p in paths)
    (gif,) = plots.export_evolution_2d(rho, str(tmp_path / "ev.gif"), dpi=40)
    assert os.path.getsize(gif) > 0
    with pytest.raises(ValueError, match="extension"):
        plots.export_evolution_2d(rho, str(tmp_path / "ev.tiff"))


def test_violation_q_matches_jax(rng):
    q0 = rng.standard_normal((4, 6, 7))
    bs = [rng.standard_normal((4, 6, 7)) for _ in range(2)]
    got = plots.violation_q(torch.from_numpy(q0),
                            [torch.from_numpy(b) for b in bs])
    np.testing.assert_array_equal(got, jplots.violation_q(q0, bs))


def _bars_and_area(fig):
    axes = fig.get_axes()
    heights = np.array([r.get_height() for r in axes[0].patches])
    area = [c for ax in axes[1:] for c in ax.collections]
    top = (np.concatenate([c.get_paths()[0].vertices[:, 1] for c in area])
           if area else np.zeros(0))
    return len(axes), heights, top


def test_hist_positive_value_corrects_the_scaling(rng):
    import matplotlib.pyplot as plt

    y = np.abs(rng.standard_normal(4000)) * 10.0 ** rng.uniform(-8, -1, 4000)
    y[:500] = 0.0  # zeros stay in the denominator, as in the reference
    got = plots.hist_positive_value(torch.from_numpy(y))
    want = jplots.hist_positive_value(y)
    n_got, h_got, a_got = _bars_and_area(got)
    n_want, h_want, a_want = _bars_and_area(want)
    assert n_got == n_want == 2
    assert h_got.size == h_want.size == 49 and h_got.sum() > 0
    # the JAX function plots percentages; the reference the fractions
    np.testing.assert_allclose(100.0 * h_got, h_want, rtol=1e-15)
    np.testing.assert_allclose(100.0 * a_got, a_want, rtol=1e-15)
    # fractions of all 4000 values: at most the 3500 positive ones
    assert 0 < h_got.sum() <= 3500 / 4000
    np.testing.assert_allclose(a_got.max(), h_got.sum(), rtol=1e-12)
    assert got.get_axes()[0].yaxis.get_major_formatter()(0.05, 0) == "0.05%"
    # no positive value: the reference still draws both axes
    n_got, h_got, _ = _bars_and_area(plots.hist_positive_value(np.zeros(8)))
    n_want, _, _ = _bars_and_area(jplots.hist_positive_value(np.zeros(8)))
    assert (n_got, n_want, h_got.size) == (2, 1, 0)
    plt.close("all")
