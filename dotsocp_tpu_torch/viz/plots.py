"""Visualization & diagnostics (the reference's top-level ``utils/`` layer);
a copy of ``dotsocp_tpu/viz/plots.py`` with its functions and signatures:
density evolution, movement quivers, residual curves, violation histograms
and the publication export, matplotlib equivalents of
``show_evolution_1d/2d``, ``show_movement_2d``, ``show_residualCurve``,
``hist_negative_density``, ``hist_violation_q_{1d,2d}``,
``hist_positive_value`` and ``export_evolution_2d``.

Every function takes numpy arrays or torch tensors on any device.
matplotlib is imported inside the functions (``_mpl``), so the package
imports where it is absent. ``hist_positive_value`` plots the reference's
fractions with a percent sign on the ticks (``ytickformat("percentage")``)
and always draws both axes; the JAX function multiplies by 100 and leaves
the cumulative axis out when no value is positive.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _np(a, dtype=None) -> np.ndarray:
    """A numpy copy of an array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def show_evolution_1d(rho, mode: str = "join", title: str = "Density evolution",
                      save: Optional[str] = None):
    """Line plots of rho(t, x) (``show_evolution_1d.m``): mode 'join'
    overlays all time slabs, 'tile' shows a panel grid."""
    plt = _mpl()
    rho = _np(rho)
    nt, nx = rho.shape
    x = np.linspace(0, 1, nx)
    if mode == "join":
        fig, ax = plt.subplots(figsize=(7, 4))
        cmap = plt.get_cmap("viridis")
        for i in range(nt):
            ax.plot(x, rho[i], color=cmap(i / max(nt - 1, 1)), lw=1)
        ax.set_title(title)
    else:
        k = min(nt, 9)
        idx = np.linspace(0, nt - 1, k).astype(int)
        cols = 3
        rows = (k + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.2 * rows))
        for ax, i in zip(np.ravel(axes), idx):
            ax.plot(x, rho[i])
            ax.set_title(f"t = {i / (nt - 1):.2f}")
        fig.suptitle(title)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


_MODES_2D = ("imshow", "contourf", "contour", "contour3", "mesh")


def _log_levels(vmax: float, n: int, with_barrier: bool):
    """Log-spaced contour levels exp(linspace(0, log(255), n)) scaled back
    to data units (the reference scales rho to [0, 255] instead —
    ``show_evolution_2d.m:59-75``); a -10-equivalent underflow level when a
    barrier is painted to -Inf."""
    lv = np.exp(np.linspace(0.0, np.log(255.0), n)) * (vmax / 255.0)
    if with_barrier:
        lv = np.concatenate([[-10.0 * vmax / 255.0], lv])
    return lv


def _draw_frame_2d(ax, frame, mode, vmax, xx, yy, with_barrier):
    """One frame in one of the five reference modes
    (``show_evolution_2d.m:52-85``). 3-D axes for contour3/mesh."""
    if mode == "imshow":
        ax.imshow(frame, origin="lower", cmap="turbo", vmin=0, vmax=vmax)
    elif mode == "contourf":
        ax.contourf(xx, yy, frame,
                    levels=_log_levels(vmax, 128, with_barrier),
                    cmap="turbo", extend="both")
    elif mode == "contour":
        ax.contour(xx, yy, frame, levels=_log_levels(vmax, 30, with_barrier),
                   cmap="turbo")
    elif mode == "contour3":
        # true 3-D contour stack (``contour3(xx, yy, rho, 30)``)
        ax.contour(xx, yy, frame, levels=30, cmap="turbo")
        ax.set_zlim(0, vmax)
        if with_barrier:
            ax.view_init(elev=86.05, azim=-35.1)  # the reference's view
    elif mode == "mesh":
        # surface with flat shading (``mesh(xx, yy, rho, FaceColor=flat)``)
        ax.plot_surface(xx, yy, frame, cmap="turbo", vmin=0, vmax=vmax,
                        rstride=1, cstride=1, linewidth=0.1,
                        antialiased=False)
        ax.set_zlim(0, vmax)
    else:
        raise ValueError(f"mode must be one of {_MODES_2D}, got {mode!r}")


def _apply_barrier_2d(rho, barrier_mask, mode):
    """The reference's barrier painting (``show_evolution_2d.m:30-48``):
    imshow saturates barrier cells to +Inf (renders max-bright), contour3
    to the global max, contour(f) to -Inf (under-range); mesh + barrier is
    invalid."""
    if barrier_mask is None:
        return rho, False
    if mode == "mesh":
        raise ValueError("mode 'mesh' is invalid with a barrier "
                         "(show_evolution_2d.m:40)")
    m = _np(barrier_mask, bool)
    rho = np.array(rho, float)
    if mode == "imshow":
        rho[:, m] = rho.max()
    elif mode == "contour3":
        rho[:, m] = rho.max()
    else:
        rho[:, m] = -np.inf
    return rho, True


def show_evolution_2d(rho, mode: str = "imshow", title: str = "Density evolution",
                      barrier_mask=None, times: Sequence[float] = (0.0, 0.5, 1.0),
                      save: Optional[str] = None):
    """Frames of rho at selected times (``show_evolution_2d.m``): the five
    reference modes 'imshow', 'contourf', 'contour', 'contour3' (3-D
    contour stack) and 'mesh' (3-D flat-shaded surface); optional barrier
    with the reference's per-mode painting."""
    plt = _mpl()
    rho = _np(rho)
    nt, ny, nx = rho.shape
    rho, with_barrier = _apply_barrier_2d(rho, barrier_mask, mode)
    idx = [int(round(t * (nt - 1))) for t in times]
    three_d = mode in ("contour3", "mesh")
    fig, axes = plt.subplots(
        1, len(idx), figsize=(3.2 * len(idx), 3.2),
        subplot_kw={"projection": "3d"} if three_d else None,
    )
    if len(idx) == 1:
        axes = [axes]
    vmax = np.nanmax(rho[np.isfinite(rho)]) if with_barrier else rho.max()
    xx, yy = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
    for ax, i in zip(np.ravel(axes), idx):
        _draw_frame_2d(ax, rho[i], mode, vmax, xx, yy, with_barrier)
        if barrier_mask is not None and not three_d and mode == "imshow":
            ax.contour(_np(barrier_mask, float), levels=[0.5],
                       colors="k", linewidths=1.0)
        ax.set_title(f"t = {i / (nt - 1):.2f}")
        if not three_d:
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle(title)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


def show_evolution_3d(rho, axis: int = 0, title: str = "Density evolution (3D)",
                      times: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
                      slices: Sequence[float] = (0.25, 0.5, 0.75),
                      save: Optional[str] = None):
    """Grid of mid-volume slices of a 3D density over time: rows = slice
    position along ``axis`` of the (nz, ny, nx) volume, columns = time.
    A 3D-DOT capability the reference does not have (its viz layer is
    1D/2D only — top-level ``utils/show_evolution_2d.m``)."""
    plt = _mpl()
    rho = _np(rho)
    nt = rho.shape[0]
    tidx = [int(round(t * (nt - 1))) for t in times]
    nslice = rho.shape[1 + axis]
    sidx = [int(round(s * (nslice - 1))) for s in slices]
    fig, axes = plt.subplots(
        len(sidx), len(tidx), figsize=(2.4 * len(tidx), 2.4 * len(sidx)),
        squeeze=False,
    )
    vmax = rho.max()
    for r, si in enumerate(sidx):
        for c, ti in enumerate(tidx):
            frame = np.take(rho[ti], si, axis=axis)
            ax = axes[r][c]
            ax.imshow(frame, origin="lower", cmap="turbo", vmin=0, vmax=vmax)
            if r == 0:
                ax.set_title(f"t = {ti / (nt - 1):.2f}")
            if c == 0:
                ax.set_ylabel(f"slice {si}/{nslice - 1}")
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle(title)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


def show_movement_2d(rho, Ex, Ey, title: str = "Density movement",
                     barrier_mask=None, t: float = 0.5, stride: int = 4,
                     save: Optional[str] = None):
    """Quiver of momentum over density (``show_movement_2d.m``)."""
    plt = _mpl()
    rho = _np(rho)
    Ex = _np(Ex)
    Ey = _np(Ey)
    nt = rho.shape[0]
    i = int(round(t * (nt - 1)))
    ie = min(i, Ex.shape[0] - 1)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(rho[i], origin="lower", cmap="Greys")
    ny, nx = rho.shape[1:]
    yy, xx = np.mgrid[0:ny:stride, 0:nx:stride]
    ax.quiver(xx, yy, Ex[ie, ::stride, ::stride], Ey[ie, ::stride, ::stride],
              color="tab:red", scale=None)
    if barrier_mask is not None:
        ax.contour(_np(barrier_mask, float), levels=[0.5], colors="b")
    ax.set_title(f"{title} (t = {i / (nt - 1):.2f})")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


def show_residual_curve(kkt, title: str = "KKT errors", names=None,
                        x=None, x_label: str = "iteration",
                        save: Optional[str] = None):
    """Semilogy KKT histories vs iteration or time (``show_residualCurve.m``)."""
    plt = _mpl()
    kkt = np.atleast_2d(_np(kkt))
    if kkt.shape[0] == 1:
        kkt = kkt.T
    n = kkt.shape[1] if kkt.ndim > 1 else 1
    fig, ax = plt.subplots(figsize=(7, 4.5))
    xs = np.arange(kkt.shape[0]) if x is None else _np(x)
    for j in range(n):
        label = names[j] if names and j < len(names) else f"kkt{j + 1}"
        ax.semilogy(xs, kkt[:, j], label=label, lw=1.2)
    ax.set_xlabel(x_label)
    ax.set_ylabel("relative residual")
    ax.set_title(title)
    ax.legend(fontsize=7)
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


def hist_negative_density(rho, title: str = "Density < 0",
                          save: Optional[str] = None):
    """Histogram of negative density values (``hist_negative_density.m``)."""
    plt = _mpl()
    vals = _np(rho).ravel()
    neg = vals[vals < 0]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    if neg.size:
        ax.hist(neg, bins=50)
    ax.set_title(f"{title} ({neg.size} values, min {vals.min():.2e})")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


def violation_q(q0, bs):
    """f(q) = q0 + (1/2) sum of centered face-value squares — the dual-cone
    violation field (``hist_violation_q_2d.m:4``)."""
    q0 = _np(q0)
    acc = np.zeros_like(q0)
    for b in bs:
        acc = acc + _np(b) ** 2
    return q0 + 0.5 * acc


def hist_violation_q(q0, bs, title: str = "f(q) > 0",
                     save: Optional[str] = None):
    """Histogram of positive f(q) values (``hist_violation_q_{1d,2d}.m``)."""
    plt = _mpl()
    f = violation_q(q0, bs).ravel()
    pos = f[f > 0]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    if pos.size:
        ax.hist(pos, bins=50)
    ax.set_title(f"{title} ({pos.size} values, max {f.max():.2e})")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


def hist_positive_value(y, title: str = "Histogram of value >= 0",
                        save: Optional[str] = None,
                        x_left: int = -8, x_right: int = -1):
    """Named port of ``utils/hist_positive_value.m``: dual-axis log10
    histogram of a nonnegative violation field: per-bin probability bars
    (left axis) over 50 log-spaced decade bins in [10^-8, 10^-1], with the
    reverse-cumulative proportion as a filled area (right axis) and the
    x-axis reversed so severity grows to the left.

    As the reference, both axes carry the fractions themselves with a
    percent sign on the ticks (``ytickformat("percentage")`` appends one to
    the raw value), and both are drawn even when no value is positive; the
    JAX function scales both by 100 and draws the right axis only for
    positive values (``dotsocp_tpu/viz/plots.py:290-337``)."""
    plt = _mpl()
    from matplotlib.ticker import FuncFormatter

    vals = np.maximum(_np(y, np.float64).ravel(), 0.0)
    total = vals.size  # the reference's 'probability' normalization
    # divides by ALL elements: zeros become log10 = -Inf, fall outside
    # the bins, but stay in the denominator (hist_positive_value.m)
    vals = vals[vals > 0]
    levels = np.linspace(x_left, x_right, 50)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax2 = ax.twinx()
    color_hist = (220 / 255, 94 / 255, 40 / 255)
    color_area = (0.0, 114 / 255, 189 / 255)
    if vals.size:
        logv = np.log10(vals)
        counts, edges = np.histogram(logv, bins=levels)
        prop = counts / max(total, 1)
        centers = 0.5 * (edges[:-1] + edges[1:])
        width = edges[1] - edges[0]
        ax.bar(centers, prop, width=width, color=color_hist)
        cum = np.cumsum(prop[::-1])[::-1]
        ax2.fill_between(centers, cum, color=color_area, alpha=0.75,
                         linewidth=0)
    percent = FuncFormatter(lambda v, _: f"{v:g}%")
    ax.yaxis.set_major_formatter(percent)
    ax2.yaxis.set_major_formatter(percent)
    ax2.set_ylabel("Cumulative percentage", color=color_area)
    ax2.tick_params(axis="y", colors=color_area)
    ax.set_ylabel("Percentage", color=color_hist)
    ax.tick_params(axis="y", colors=color_hist)
    ax.set_xlabel("Violation")
    ticks = np.arange(x_left, x_right + 1)
    ax.set_xticks(ticks)
    ax.set_xticklabels([f"$10^{{{t}}}$" for t in ticks])
    ax.invert_xaxis()
    ax.set_title(title)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig


def _publication_style(ax, mode: str):
    """The reference's figure polish (``export_evolution_2d.m``
    setGraphic_* + adjust_fig of ``show_evolution_2d.m``): serif/Times
    fonts, fontsize 12, axis linewidth 1.5, per-mode margins (imshow:
    near-full-bleed, no axes; contour(f): 2-D axes with margins;
    contour3/mesh: 3-D axes)."""
    three_d = hasattr(ax, "get_zlim")
    for item in ([ax.title] + ax.get_xticklabels() + ax.get_yticklabels()):
        item.set_fontsize(12)
        item.set_fontfamily("serif")
    if not three_d:
        for sp in ax.spines.values():
            sp.set_linewidth(1.5)
    if mode == "imshow":
        ax.set_axis_off()
        ax.set_position([0.05, 0.0, 0.90, 1.0])   # setGraphic_WOAxis
    elif mode == "contourf":
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_position([0.05, 0.05, 0.90, 0.90])  # setGraphic_WO2dimAxis
    elif mode == "contour":
        ax.set_position([0.15, 0.10, 0.80, 0.85])  # setGraphic_W2dimAxis
    ax.set_title("")


def export_evolution_2d(rho, path: str, num_frame: int = 6,
                        mode: str = "imshow", barrier_mask=None,
                        colorbar: bool = False, dpi: int = 600):
    """Publication-grade evolution export (``export_evolution_2d.m``).

    ``path`` selects the format by extension: '.pdf'/'.png'/'.jpg' write a
    per-frame image series ``name-t=<x>.<ext>`` (``num_frame`` frames,
    timestamps rounded to the reference's precision rule, 600 dpi);
    '.gif'/'.mp4'/'.avi' write an animation of all nt frames over ~5 s
    (the reference's video profiles, ``export_evolution_2d.m:165-204``).
    Video formats use matplotlib's FFMpegWriter when ffmpeg is installed;
    otherwise the export degrades to a '.gif' next to the requested path
    (warned, and the returned path list tells the truth). Frames use the
    reference's per-mode margins/fonts; imshow frames are value-inverted
    like the reference's export path (``export_evolution_2d.m:90-92``:
    rho2 = maxVal - rho on white)."""
    import os
    import warnings

    plt = _mpl()
    rho = _np(rho)
    nt, ny, nx = rho.shape
    root, ext = os.path.splitext(path)
    ext = ext.lower()
    if ext in (".mp4", ".avi"):
        from matplotlib import animation

        if not animation.writers.is_available("ffmpeg"):
            warnings.warn(
                f"ffmpeg not available: exporting '{root}.gif' instead of "
                f"'{path}'", stacklevel=2,
            )
            ext, path = ".gif", root + ".gif"
    if ext not in (".pdf", ".png", ".jpg", ".gif", ".mp4", ".avi"):
        raise ValueError(f"unsupported export extension {ext!r}")
    d = os.path.dirname(root)
    if d:
        os.makedirs(d, exist_ok=True)

    rho_p, with_barrier = _apply_barrier_2d(rho, barrier_mask, mode)
    vmax = (np.nanmax(rho_p[np.isfinite(rho_p)]) if with_barrier
            else rho_p.max())
    xx, yy = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
    three_d = mode in ("contour3", "mesh")

    def render(ax, i):
        if mode == "imshow":
            # the export path inverts values onto white paper
            ax.imshow(vmax - rho_p[i], origin="lower", cmap="gray",
                      vmin=0, vmax=vmax)
        else:
            _draw_frame_2d(ax, rho_p[i], mode, vmax, xx, yy, with_barrier)
        _publication_style(ax, mode)

    if ext in (".gif", ".mp4", ".avi"):
        from matplotlib.animation import FFMpegWriter, FuncAnimation, \
            PillowWriter

        fig, ax = plt.subplots(
            figsize=(8, 8),
            subplot_kw={"projection": "3d"} if three_d else None,
        )

        def update(i):
            ax.clear()
            render(ax, i)
            return []

        fps = max(nt / 5.0, 1.0)
        if ext == ".gif":
            writer = PillowWriter(fps=fps)
        else:
            # the reference's video profiles ('MPEG-4' / 'Motion JPEG AVI',
            # export_evolution_2d.m:169-176) -> libx264 mp4 / mjpeg avi
            codec = "mpeg4" if ext == ".mp4" else "mjpeg"
            writer = FFMpegWriter(fps=fps, codec=codec)
        anim = FuncAnimation(fig, update, frames=nt)
        anim.save(path, writer=writer)
        plt.close(fig)
        return [path]

    # image series: frame indices + timestamp precision rule
    # (``export_evolution_2d.m:146-158``)
    ind = np.round(np.linspace(0, nt - 1, num_frame)).astype(int)
    flops = 2 if num_frame <= 20 else (3 if num_frame <= 200 else 4)
    paths = []
    for i in ind:
        fig, ax = plt.subplots(
            figsize=(8, 8),
            subplot_kw={"projection": "3d"} if three_d else None,
        )
        fig.patch.set_facecolor("white")
        render(ax, i)
        if colorbar and mode in ("imshow", "contourf"):
            sm = plt.cm.ScalarMappable(
                cmap="gray" if mode == "imshow" else "turbo",
                norm=plt.Normalize(0, vmax))
            fig.colorbar(sm, ax=ax, fraction=0.046, pad=0.02)
        t_val = round(i / (nt - 1), flops)
        p = f"{root}-t={t_val:.{flops}f}{ext}"
        fig.savefig(p, dpi=dpi, facecolor="white")
        plt.close(fig)
        paths.append(p)
    return paths
