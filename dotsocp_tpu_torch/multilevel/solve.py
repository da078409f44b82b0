"""Top-level multilevel solver API; port of
``dotsocp_tpu/multilevel/solve.py:462-680`` (``solve_dot``) in 1D, 2D and
3D: the unweighted problem with every method of the JAX package's
``DOT_METHODS`` (acc-ADMM with its Halpern branch, theta = 2, and its
Nesterov branch, any other theta), and the weighted (obstacle) problem with
those of ``WDOT_METHODS``.

``solve_dot(rho0, rho1, nt, level_n, opts, method, weight=..., barrier=...,
device=...)`` builds the coarse pyramid (weights and densities), runs the
algorithm per level with warm-started sigma and E2 feedback, prolongates
between levels, and recovers (rho, E, q). With ``opts={"profile": True}``
each level report also holds ``phases``, the per-phase times of
``utils/profiling.profile_phases`` on the level's final state. The JAX
package's options are taken as follows (``_check_request``): its solver
cache and ``prewarm`` work as there (below); ``use_pallas`` takes
"auto" or True (the CUDA kernels run at every size for float32, float64
takes the plain route by dtype; under a mesh only "auto", as the kernels
that read neighbouring cells run plain there), ``layout`` "auto",
"flat", "halo" and "3d" (one process runs the flat engine: "halo" without
a mesh warns and runs flat, as in the JAX package, and so does "3d",
whose shaped engine, ``ops/engine.Ops3D``, takes the flat engine's
iterations more slowly and is kept as its test oracle; under a mesh "flat"
and "3d" raise, where the JAX package hands its shaped engine to XLA's
GSPMD partitioner; the TPU-only "shaped" raises); ``driver``
takes "auto", "device" and "host" with the JAX package's rule
(``_make_solver``; a mesh forces the device driver): the device driver
(``algorithms/device_driver.py``, CUDA-graph segments) unless the caller
asks for the host driver, or "auto" meets ``ifCheckStepByStep``, or
acc-ADMM runs its Nesterov branch (theta != 2, host only);
``chunk_iters``, ``max_chunks`` and ``checkpoint_dir``
(``<dir>/level<n>.npz``, resumed from; under a mesh one file a rank,
``level<n>.rank<r>.npz``) are the device driver's.

The solver cache (``dotsocp_tpu/multilevel/solve.py:85-210``): with
``opts["reuse_solvers"]`` (default True) each level's solver is looked up
under a key of everything it keeps as it was built (``_solver_cache_key``:
method, driver, geometry, tau, a content digest of the weight, the
checks, dtype, maxit, restart, rho, theta, mesh, DCT strategy,
chunk options, checkpoint path, device, D and scaling) and reused: a
device driver as the object, with its kernels, its DCT operators, its
state buffers and its captured CUDA graphs (a solve that hits makes no
capture and no eager run: ``algorithms/device_driver.py``); a host driver
as its kernels, around which a fresh solver is built (it keeps per-solve
state). E, which the problem sets from level 2 on, is a tensor of the
device driver's state (``algorithms/core.EScalars``), so one driver serves
every problem of its key. The cache holds ``_SOLVER_CACHE_MAX`` entries,
least recently used first out; an evicted device driver frees its graphs,
their pool and its buffers, and ``clear_solver_cache()`` frees them all.
``reuse_solvers=False`` builds every level afresh and keeps nothing.
``opts["prewarm"]`` builds every level's solver into the cache before
level 1 runs and captures each device driver's pieces on a throwaway
state from the pyramid (``_prewarm_levels``), so that the solve starts on
replays; it changes no result. A cached level's memory stays on the card
until its entry leaves the cache.

``opts["mesh"]`` (a ``parallel/sharding.Mesh``, every rank of the world
calling ``solve_dot`` with the same arguments) runs each level on the halo
engine (``ops/halo_engine.py``), one block of the grid a rank, under the
device driver (``dotsocp_tpu/multilevel/solve.py:158-194,239-262``);
prolongation, ``recover_solution`` and the mass check run on the gathered
fields, so every rank returns the same result dict. Only the coordinator
(rank 0) prints and writes the ``trace_dir`` profile.

``opts["refine_tol"]`` continues the finest level in float64 to a tighter
tolerance (the mixed-precision refine tail of
``dotsocp_tpu/multilevel/solve.py:681-819``), with ``refine_dtype``,
``refine_method``, ``refine_dct_split`` (False, "auto", "ir", "ir1"),
``refine_sigma_scale`` and ``refine_tau``; ``debug_nans`` raises
FloatingPointError at a KKT check that reads a residual that is not
finite; ``trace_dir`` writes a ``torch.profiler`` Chrome trace of the
whole solve there.
"""
from __future__ import annotations

import hashlib
import math
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..algorithms.core import (Kernels, LevelConfig, check_mesh_opts,
                               warn_single_process_layout)
from ..algorithms.device_driver import AccDeviceDriver, DeviceDriver
from ..algorithms.device_sgs import AccSgsDeviceDriver, SgsDeviceDriver
from ..algorithms.driver import SolveOptions
from ..algorithms.solvers import (AccADMMSolver, AccSgsADMMSolver,
                                  ALG2Solver, InPALMSolver, PALMSolver,
                                  SgsInPALMSolver)
from ..algorithms.variants import (AccADMMKernels, AccADMMNesterovKernels,
                                   AccSgsADMMKernels, PALMKernels, SgsKernels)
from ..ops.engine import OpsFlat
from ..ops.poisson import is_split
from .level import (
    LevelVar,
    initial_scaling,
    initialize,
    make_c,
    recover_org_var,
    recover_solution,
)
from ..models.wdot2d import ensure_barrier_validity
from ..ops.staggered import Staggered
from ..utils.profiling import profile_phases
from ..utils.trace import span
from .transfer import (prolong_phi, prolong_z_like, restrict_density,
                       restrict_staggered)

METHODS = ("PALM", "inPALM", "ALG2", "acc-ADMM", "sGS-inPALM",
           "acc-sGS-ADMM")
WDOT_METHODS = ("inPALM", "ALG2", "acc-ADMM")

KKT_LEGEND = [
    "||A psi - q|| / (1 + ||A psi|| + ||q||)",
    "||B F q + d - z|| / (1 + ||d||)",
    "||A* alpha + c|| / (1 + ||c||)",
    "||z - Pi_Q(z - beta)|| / (1 + ||z|| + ||beta||)",
    "||F* B* beta + alpha|| / (1 + ||F* B* beta|| + ||alpha||)",
    "||alpha1 - Pi_+(alpha1 + f(q))|| / (1 + ||alpha1|| + ||f(q)||)",
    "||alpha2 - g(alpha1, q)|| / (1 + ||alpha2|| + ||g(alpha1, q)||)",
]

ADMM_MAXIT = 3000
SGS_MAXIT = 6000
WDOT_MAXIT = 10000
ALM_STEPSIZE = 1.9
ALG2_STEPSIZE = 1.0

# options of the JAX solve_dot this port takes
KNOWN_OPTS = {"tol", "maxit", "sigma", "time_limit", "scaling",
              "ifCheckStepByStep", "checkPrimDualFeas", "restart", "rho",
              "theta", "profile", "refine_tol", "refine_dtype",
              "refine_method", "refine_dct_split", "refine_sigma_scale",
              "refine_tau", "debug_nans", "trace_dir", "chunk_iters",
              "max_chunks", "checkpoint_dir", "mesh", "prewarm",
              "reuse_solvers"}
# JAX options of which the port runs some values (_check_choice)
CHOICE_OPTS = {"use_pallas", "layout", "driver"}
LAYOUTS = ("auto", "flat", "halo", "3d")
# the port's refine_dct_split="auto", a fixed rule: the plain float64 DCT.
# The JAX package picks the IR solve because the TPU emulates f64 matmuls
# (its solve.py:746-760); the H100 runs them natively. Measured on an H100
# 80GB HBM3 at 700 W (chip_smoke.py phase 4h, PERF.md section 6): one f64
# tail iteration 3.25 / 5.56 / 4.47 ms under False / "ir" / "ir1" at
# 129^2 x 33 and 26.5 / 36.2 / 31.3 ms at 513^2 x 65 (the DCT solve alone
# 0.29 / 2.53 / 1.55 and 2.72 / 12.4 / 7.50 ms); the north star's tail took
# 4,409 iterations under each, in 14.5 / 24.9 / 19.8 s
AUTO_DCT_SPLIT = False


def _is_sgs(method: str) -> bool:
    return method in ("sGS-inPALM", "acc-sGS-ADMM")


def _check_choice(key, value):
    """Raises, with the reason, for a value of a ``CHOICE_OPTS`` option
    the port does not run."""
    if key == "use_pallas" and value not in ("auto", True):
        raise ValueError(f"use_pallas={value!r}: the port's CUDA kernels "
                         f"always run on the card for float32 (float64 takes "
                         f"the plain route); they cannot be turned off")
    if key == "layout" and value not in LAYOUTS:
        if value == "shaped":
            raise ValueError("layout='shaped': the shaped layout is "
                             "TPU-only; the port runs the flat engine on one "
                             "process and the halo engine under a mesh")
        raise ValueError(f"layout={value!r}: not one of "
                         f"{', '.join(map(repr, LAYOUTS))}")
    if key == "driver" and value not in ("auto", "host", "device"):
        raise ValueError(f"driver={value!r}: not one of 'auto', 'host', "
                         f"'device'")


def _refine_dtype(value) -> torch.dtype:
    """``opts["refine_dtype"]`` as a torch dtype: torch.float64 or float32,
    or their numpy or string names (a JAX user passes jnp.float64)."""
    dtype = value
    if not isinstance(value, torch.dtype):
        try:
            dtype = {np.dtype(np.float64): torch.float64,
                     np.dtype(np.float32): torch.float32}.get(np.dtype(value))
        except TypeError:
            dtype = None
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"refine_dtype={value!r}: not float64 or float32")
    return dtype


def _refine_split(value):
    """``opts["refine_dct_split"]`` checked, "auto" resolved to the port's
    rule (``AUTO_DCT_SPLIT``)."""
    if value is True:
        raise ValueError(
            "refine_dct_split=True: the split-f32 DCT (double-word f32 "
            "matmuls) works around the TPU's emulated f64; the H100 runs "
            "f64 matmuls natively, so the port has no split path (use "
            "False, 'auto', 'ir' or 'ir1')")
    if isinstance(value, str) and value == "auto":
        return AUTO_DCT_SPLIT
    if not is_split(value):
        raise ValueError(f"refine_dct_split={value!r}: not one of False, "
                         f"'auto', 'ir', 'ir1'")
    return value


def _check_mesh(mesh, opts) -> None:
    """A mesh for one instance's grid: a port Mesh this rank belongs to,
    with no batch axis (a fleet's), and the options it runs with."""
    from ..parallel.sharding import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: not a dotsocp_tpu_torch mesh "
                        f"(parallel/sharding.make_mesh)")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not in the mesh "
                         f"{mesh.shape}")
    if mesh.shape.get("batch", 1) > 1:
        raise ValueError(f"mesh {mesh.shape}: a batch axis carries a "
                         f"fleet's instances (solve_batch); solve_dot splits "
                         f"one grid over y/x/z/t")
    check_mesh_opts(opts, "solve_dot")
    if opts.get("profile"):
        raise ValueError("profile under a mesh: profile_phases times one "
                         "card's kernels on the flat layout; profile the "
                         "single-process solve")


def _check_request(rho0, method, weight, opts):
    methods = METHODS if weight is None else WDOT_METHODS
    if method not in methods:
        raise ValueError(f"method {method!r} not in {methods}")
    if weight is not None and not isinstance(weight, Staggered):
        raise TypeError("weight must be a dotsocp_tpu_torch Staggered (see "
                        "models/wdot2d.py, utils/interop.weight_from_numpy)")
    for key, value in opts.items():
        if key == "mesh" and value is not None:
            _check_mesh(value, opts)
        if key == "checkpoint_dir" and value is not None and \
                not isinstance(value, (str, os.PathLike)):
            raise TypeError(f"checkpoint_dir={value!r}: not a directory path")
        if key in CHOICE_OPTS:
            _check_choice(key, value)
        elif key not in KNOWN_OPTS:
            raise ValueError(f"unknown option {key!r}")
    if np.ndim(rho0) not in (1, 2, 3):
        raise ValueError(f"rho0 has {np.ndim(rho0)} axes; solve_dot takes "
                         f"1D, 2D and 3D densities")


def _cat_hist(hists):
    """Concatenate per-level histories with time/iter offsets
    (``solver_dotsocp2d.m:389-407``)."""
    out = {"kkt": [], "time": [], "iter": [], "pdGap": []}
    t_off = 0.0
    i_off = 0
    for h in hists:
        out["kkt"].append(h["kkt"])
        out["pdGap"].append(h["pdGap"])
        out["time"].append(h["time"] + t_off)
        out["iter"].append(h["iter"] + i_off)
        if len(h["time"]):
            t_off = out["time"][-1][-1]
            i_off = out["iter"][-1][-1]
    return {
        "kkt": np.concatenate(out["kkt"]) if out["kkt"] else np.zeros((0, 7)),
        "time": np.concatenate(out["time"]),
        "iter": np.concatenate(out["iter"]),
        "pdGap": np.concatenate(out["pdGap"]),
        "len": sum(len(h["iter"]) for h in hists),
    }


def _jump_next_level(lv: LevelVar, rho0_f, rho1_f, nt_f: int, dtype,
                     weight_f: Optional[Staggered] = None) -> LevelVar:
    """Prolongate (phi, beta), build the fine model, and warm-start
    q = A phi, alpha = -(BF)^T beta (``jump_nextLevel.m``; weighted: both
    divided by the fine weight, ``dotsocp_tpu/multilevel/solve.py:320-359``).
    The gradient and the BF adjoint go through the flat engine and back:
    the values equal the shaped operators'
    (``dotsocp_tpu/ops/engine.py:24-26``)."""
    lv_f = initialize(rho0_f, rho1_f, nt_f, dtype=dtype,
                      device=lv.phi.device, weight=weight_f)
    ops = OpsFlat(lv_f.geom, dtype, lv.phi.device)
    phi_f = prolong_phi(lv.phi.to(dtype))
    beta_f = prolong_z_like(lv.beta.to(dtype))
    lv_f.phi = phi_f
    lv_f.beta = beta_f
    lv_f.q = ops.stag_from_internal(ops.grad(ops.phi_to_internal(phi_f)))
    lv_f.alpha = ops.stag_from_internal(
        ops.bfd_T(ops.z_to_internal(-beta_f), 1.0))
    if weight_f is not None:
        lv_f.q = lv_f.q / weight_f
        lv_f.alpha = lv_f.alpha / weight_f
    return lv_f


def uses_device_driver(method: str, driver: str, o: SolveOptions,
                       theta: float = 2.0, mesh=None) -> bool:
    """The JAX package's rule (``dotsocp_tpu/multilevel/solve.py:255-312``):
    "device" and "auto" run the device driver, except that "auto" keeps the
    host driver under ``ifCheckStepByStep``; a mesh forces the device
    driver; acc-ADMM's Nesterov branch (theta != 2) runs on the host driver
    only."""
    if method == "acc-ADMM" and theta != 2.0:
        return False
    return driver == "device" or mesh is not None or (
        driver == "auto" and not o.check_step_by_step)


def _make_solver(method: str, lv: LevelVar, o: SolveOptions, device,
                 dtype, theta: float = 2.0, dct_split=False,
                 driver: str = "auto", checkpoint_path=None,
                 device_kw=None, mesh=None):
    """The level solver of ``method`` (``dotsocp_tpu/multilevel/solve.py:
    236-313``): the device driver or the host driver by
    :func:`uses_device_driver`; acc-ADMM with ``theta`` != 2 runs its
    Nesterov branch; ``dct_split`` is the DCT solve's f64 strategy;
    ``checkpoint_path`` and ``device_kw`` (chunk_iters, max_chunks) are
    the device driver's; ``mesh`` puts the level on the halo engine, else
    it runs the flat engine."""
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=str(device),
                      tau=o.tau, dtype=dtype, dct_split=dct_split,
                      mesh=mesh)
    w = lv.weight
    if method == "acc-ADMM" and theta != 2.0:
        return AccADMMSolver(AccADMMNesterovKernels(cfg, w, o.restart, o.rho,
                                                    theta), o)
    if method in ("inPALM", "ALG2"):
        k = Kernels(cfg, w)
        host, dev = (ALG2Solver if method == "ALG2" else InPALMSolver,
                     DeviceDriver)
    elif method == "acc-ADMM":
        k = AccADMMKernels(cfg, w, o.restart, o.rho)
        host, dev = AccADMMSolver, AccDeviceDriver
    # the methods below are not in WDOT_METHODS: w is None
    elif method == "PALM":
        k = PALMKernels(cfg)
        host, dev = PALMSolver, DeviceDriver
    elif method == "sGS-inPALM":
        k = SgsKernels(cfg)
        host, dev = SgsInPALMSolver, SgsDeviceDriver
    else:
        k = AccSgsADMMKernels(cfg, o.restart, o.rho)
        host, dev = AccSgsADMMSolver, AccSgsDeviceDriver
    if uses_device_driver(method, driver, o, theta, mesh):
        return dev(k, o, checkpoint_path=checkpoint_path, **(device_kw or {}))
    return host(k, o)


# -- the solver cache ----------------------------------------------------------

_SOLVER_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_SOLVER_CACHE_MAX = 10


def _weight_digest(w: Optional[Staggered]) -> Optional[tuple]:
    """A content digest of a level's weight, block by block (dtype, shape
    and bytes): the cached kernels hold the weight, so an object's identity
    cannot key them (``dotsocp_tpu/multilevel/solve.py:90-114``)."""
    if w is None:
        return None
    parts = []
    for b in w.blocks():
        h = hashlib.sha1(f"{b.dtype} {tuple(b.shape)}".encode())
        h.update(b.detach().contiguous().cpu().numpy().tobytes())
        parts.append(h.hexdigest())
    return tuple(parts)


def _solver_cache_key(method: str, lv: LevelVar, o: SolveOptions, device,
                      dtype, theta: float, dct_split, driver: str,
                      checkpoint_path, device_kw, mesh) -> tuple:
    """Everything a cached solver keeps as it was built: the JAX key's parts
    (``dotsocp_tpu/multilevel/solve.py:116-148``), and the port's own: the
    device, D and scaling, which its pieces take as Python numbers (D is
    fixed by the geometry and the weight, scaling picks the branch of the
    check that keeps the rescale decisions). The mesh keys by identity as
    well (and keeps a level of the halo engine apart from one of the flat
    engine): the cached level holds its process groups and counts its
    traffic, and every rank makes the same calls, so all hit or miss
    together."""
    mesh_key = None if mesh is None else (
        mesh.axis_names, tuple(mesh.shape.values()), mesh.ranks, id(mesh))
    return (method, driver, lv.geom, float(o.tau), _weight_digest(lv.weight),
            bool(o.check_prim_dual_feas), str(dtype), int(o.maxit),
            int(o.restart), float(o.rho), float(theta),
            bool(o.check_step_by_step), checkpoint_path, mesh_key,
            str(dct_split),
            tuple(sorted((device_kw or {}).items())), str(device),
            float(lv.D), bool(o.scaling))


def _free(entry) -> None:
    if isinstance(entry, DeviceDriver):
        entry.free()


def clear_solver_cache() -> None:
    """Empty the solver cache: every cached device driver drops its graphs,
    their pool and its buffers, and PyTorch's allocator hands the freed
    memory back to the card."""
    for entry in _SOLVER_CACHE.values():
        _free(entry)
    _SOLVER_CACHE.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _build_solver(method: str, lv: LevelVar, o: SolveOptions, device, dtype,
                  theta: float = 2.0, dct_split=False, driver: str = "auto",
                  checkpoint_path=None, device_kw=None, mesh=None,
                  reuse: bool = True):
    """The level's solver (:func:`_make_solver`), from the cache when
    ``reuse`` and a solver of the same key is there (the JAX
    ``_build_solver``): a device driver is reused as it is, with ``o`` (its
    runtime options: sigma, tol, the time limit, the label) set; a host
    driver is built afresh around the cached kernels. A miss builds the
    solver and caches it, evicting the least recently used entry beyond
    ``_SOLVER_CACHE_MAX``."""
    args = (method, lv, o, device, dtype, theta, dct_split, driver,
            checkpoint_path, device_kw, mesh)
    if not reuse:
        return _make_solver(*args)
    key = _solver_cache_key(*args)
    entry = _SOLVER_CACHE.get(key)
    if entry is not None:
        _SOLVER_CACHE.move_to_end(key)
        if isinstance(entry, DeviceDriver):
            entry.opts = o
            return entry
        return entry(o)
    solver = _make_solver(*args)
    if isinstance(solver, DeviceDriver):
        solver.cached = True
        _SOLVER_CACHE[key] = solver
    else:
        # the host drivers keep per-solve state: cache their kernels
        kernels, cls = solver.k, type(solver)
        _SOLVER_CACHE[key] = lambda opts: cls(kernels, opts)
    while len(_SOLVER_CACHE) > _SOLVER_CACHE_MAX:
        _free(_SOLVER_CACHE.popitem(last=False)[1])
    return solver


def _pyramid(rho0, rho1, nt: int, level_n: int, tol: float, weight,
             barrier, device, dtype):
    """The coarse levels' densities, time steps, tolerances and weights,
    finest last (``solver_dotsocp2d.m:124-130,166-178``)."""
    weighted = weight is not None
    tol_factor = -1.0 if tol > 0.99e-3 else -0.5
    tol_lower = 1e-5 if np.ndim(rho0) == 1 else 1e-4
    rho0s = [None] * level_n
    rho1s = [None] * level_n
    nts = [0] * level_n
    tols = [0.0] * level_n
    weights = [None] * level_n
    rho0s[-1] = torch.as_tensor(rho0, device=device).to(dtype)
    rho1s[-1] = torch.as_tensor(rho1, device=device).to(dtype)
    nts[-1] = nt
    tols[-1] = tol
    if weighted:
        weights[-1] = weight.to(dtype=dtype, device=device)
    for lev in range(level_n - 2, -1, -1):
        nts[lev] = (nts[lev + 1] - 1) // 2 + 1
        tols[lev] = max(tols[lev + 1] * 2.0 ** tol_factor, tol_lower)
        r0 = restrict_density(rho0s[lev + 1])
        r1 = restrict_density(rho1s[lev + 1])
        if weighted:
            weights[lev] = restrict_staggered(weights[lev + 1],
                                              log_space=barrier is not None)
        if weighted and barrier is not None:
            # zero the mass on the coarse walls, renormalize (host numpy,
            # ``solve.py:557-580``)
            r0, r1, _ = ensure_barrier_validity(r0, r1, barrier)
            r0 = torch.as_tensor(r0, device=device).to(dtype)
            r1 = torch.as_tensor(r1, device=device).to(dtype)
        else:
            # renormalize to unit mean (``solver_dotsocp2d.m:174-178``)
            r0 = r0 / r0.mean()
            r1 = r1 / r1.mean()
        rho0s[lev] = r0
        rho1s[lev] = r1
    return rho0s, rho1s, nts, tols, weights


def _prewarm_levels(level_solver, rho0s, rho1s, nts, weights, dtype, device,
                    scaling: bool, verbose: bool) -> None:
    """Every level's solver built into the cache before level 1 runs, and
    each device driver's pieces captured on a throwaway state from the
    pyramid (``DeviceDriver.warm``; the JAX ``_prewarm_levels``,
    ``dotsocp_tpu/multilevel/solve.py:368-436``, compiles each level's
    loop). The throwaway state is the level's initial state, scaled without
    the E2 feedback: its E is not the solve's, which the cached driver
    reads from its state. ``level_solver(lev, lv)`` is the function the
    solve takes its levels from, so each lands under the key it looks up."""
    t0 = time.monotonic()
    warmed = 0
    for lev in range(len(nts)):
        lv = initialize(rho0s[lev], rho1s[lev], nts[lev], dtype=dtype,
                        device=device, weight=weights[lev])
        initial_scaling(lv, scaling)
        solver = level_solver(lev, lv)
        if isinstance(solver, DeviceDriver):
            solver.warm(lv.as_dict())
            warmed += 1
    if verbose:
        print(f"prewarm: {len(nts)} level solvers built, {warmed} device "
              f"drivers captured in {time.monotonic() - t0:.2f}s")


def solve_dot(
    rho0,
    rho1,
    nt: int,
    level_n: int = 1,
    opts: Optional[dict] = None,
    method: str = "inPALM",
    weight: Optional[Staggered] = None,
    barrier=None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    verbose: bool = True,
):
    """Multilevel DOT-SOCP solve on ``device``: the card unless the caller
    asks for another device (``device="cpu"`` runs the plain versions of
    the kernels); without a card the default raises, it never falls back
    to the CPU. Returns (output, run_hist_ml, run_hist) like the JAX
    ``solve_dot``.

    ``weight`` (a shaped :class:`Staggered` of the finest grid, e.g.
    ``models.wdot2d.get_weight_by_barrier``) switches to the weighted
    problem, with a method of ``WDOT_METHODS``; ``barrier`` (the predicate
    the weight was built from) restricts the weight in log space and
    re-validates the coarse densities against it.

    output: rho (nt, *space), E (list per axis; Ex/Ey aliases in 2D, Ex
    in 1D, none in 3D), q0, b (list per axis, aliased alike), mass_ok,
    per-level reports (with ``opts["refine_tol"]`` one more, the float64
    tail's, ``"refine": True``; rho and the fields are then float64),
    total_time (from level 1's scaling to the last level's recovery),
    spans.

    ``spans`` says where the wall outside the levels' loops went: the host
    seconds of the solve's steps, summed over the call, by name:
    ``pyramid_s`` (the coarse densities and level 1's initial variables),
    ``prewarm_s`` (``opts["prewarm"]``: every level's cache lookup and
    ``DeviceDriver.warm``), and over the levels ``level.scaling_s``
    (``initial_scaling``), ``level.build_s`` (the solver's cache lookup or
    build), ``level.loop_s`` (the solver's ``solve``: the device driver's
    prepare, loop and finish), ``level.prolong_s`` (the jump to the next
    level) and ``level.recover_s`` (``recover_org_var`` and the final
    ``recover_solution``); a step that did not run has no key. While a
    ``torch.profiler`` runs (``trace_dir``'s too), these steps, the call
    (``dotsocp.solve``) and the device driver's steps
    (``dotsocp.driver.*``) are host ranges ``dotsocp.<name>`` of its trace
    (``utils/trace.py``).
    """
    opts = dict(opts or {})
    _check_request(rho0, method, weight, opts)
    if not (isinstance(level_n, int) and level_n >= 1):
        raise ValueError("level_n must be a positive integer")
    device = torch.device(device)
    if opts.get("mesh") is not None:
        from ..parallel.distributed import is_coordinator

        # one rank speaks for the mesh
        verbose = verbose and is_coordinator()
        if not is_coordinator():
            opts.pop("trace_dir", None)
    args = (rho0, rho1, nt, level_n, opts, method, weight, barrier, device,
            dtype, verbose)
    trace_dir = opts.get("trace_dir")
    if not trace_dir:
        with span("solve"):
            return _solve_dot_impl(*args)
    # a torch.profiler trace of the whole solve (the JAX package's
    # jax.profiler trace, ``solve.py:494-507``), written in the finally so
    # that a solve that raises still leaves one
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with span("solve"):
            return _solve_dot_impl(*args)
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"solve_dot_{os.getpid()}_{time.time_ns()}"
                       f".pt.trace.json"))


def _solve_dot_impl(rho0, rho1, nt, level_n, opts, method, weight, barrier,
                    device, dtype, verbose):
    if dtype == torch.float32 and float(opts.get("tol", 1e-4)) < 5e-5 \
            and verbose:
        print("WARNING: float32 stalls around KKT ~1e-4; tolerances below "
              "5e-5 need dtype=torch.float64.")

    weighted = weight is not None
    sgs_method = _is_sgs(method)
    tol = float(opts.get("tol", 1e-4))
    scaling = bool(opts.get("scaling", True))
    maxit = int(opts.get("maxit", WDOT_MAXIT if weighted else (
        SGS_MAXIT if sgs_method else ADMM_MAXIT)))
    sigma = float(opts.get("sigma", 0.1 if sgs_method else 1.0))
    time_limit = float(opts.get("time_limit", 3600.0))
    check_sbs = bool(opts.get("ifCheckStepByStep", False))
    # weighted problems stop on residuals 1, 3, 6
    # (``dotsocp_tpu/multilevel/solve.py:532``)
    check_pdf = bool(opts.get("checkPrimDualFeas", not weighted))
    theta = float(opts.get("theta", 2.0))
    profile = bool(opts.get("profile", False))
    debug_nans = bool(opts.get("debug_nans", False))
    driver = str(opts.get("driver", "auto"))
    mesh = opts.get("mesh")
    if mesh is None:
        # the engine of one process is the flat one
        # (``dotsocp_tpu/multilevel/solve.py:168-181``)
        warn_single_process_layout(opts, stacklevel=3)
    ckpt_dir = opts.get("checkpoint_dir")
    # under a mesh each rank checkpoints its own block
    ckpt_name = "level{}.npz" if mesh is None or mesh.size == 1 else \
        f"level{{}}.rank{mesh.rank}.npz"
    device_kw = {k: int(opts[k]) for k in ("chunk_iters", "max_chunks")
                 if k in opts}
    reuse = bool(opts.get("reuse_solvers", True))
    if method in ("PALM", "inPALM", "sGS-inPALM"):
        tau = ALM_STEPSIZE
    elif method == "ALG2":
        tau = ALG2_STEPSIZE
    else:
        tau = 1.0  # acc-ADMM multiplier steps are unit

    # host seconds of the solve's steps outside the levels' loops
    spans = {}
    with span("pyramid", spans):
        rho0s, rho1s, nts, tols, weights = _pyramid(
            rho0, rho1, nt, level_n, tol, weight, barrier, device, dtype)
        lv = initialize(rho0s[0], rho1s[0], nts[0], dtype=dtype,
                        device=device, weight=weights[0])

    def level_solver(lev: int, lv: LevelVar, sigma: float = sigma,
                     time_limit: float = time_limit):
        """Level ``lev``'s solver, through the cache."""
        o = SolveOptions(tol=tols[lev], maxit=maxit, sigma=sigma, tau=tau,
                         time_limit=time_limit, scaling=scaling,
                         check_step_by_step=check_sbs,
                         check_prim_dual_feas=check_pdf,
                         restart=int(opts.get("restart", 100)),
                         rho=float(opts.get("rho", 2.0)),
                         debug_nans=debug_nans, label=f"level {lev + 1}")
        lev_method = method
        if sgs_method and lev < level_n - 1:
            # non-final levels of sGS methods run inPALM
            # (``solver_dotsocp2d.m:209-223``)
            lev_method = "inPALM"
            o.maxit = ADMM_MAXIT
            o.tau = ALM_STEPSIZE
        return _build_solver(
            lev_method, lv, o, device, dtype, theta, driver=driver,
            checkpoint_path=(os.path.join(ckpt_dir, ckpt_name.format(lev + 1))
                             if ckpt_dir else None),
            device_kw=device_kw, mesh=mesh, reuse=reuse)

    if opts.get("prewarm") and reuse:
        with span("prewarm", spans):
            _prewarm_levels(level_solver, rho0s, rho1s, nts, weights, dtype,
                            device, scaling, verbose)

    last_kkt = None
    prev_e2 = None
    hists = []
    level_reports = []
    t_start = time.monotonic()

    for lev in range(level_n):
        with span("level.scaling", spans):
            initial_scaling(lv, scaling, last_kkt, prev_e2)
        prev_e2 = lv.E2
        with span("level.build", spans):
            t_build = time.monotonic()
            solver = level_solver(lev, lv, sigma, time_limit)
            build_s = time.monotonic() - t_build
        with span("level.loop", spans):
            hist, out = solver.solve(lv.as_dict())
        hist["method"] = solver.name
        hists.append(hist)

        with span("level.recover", spans):
            recover_org_var(lv, out)
        report = {"level": lev + 1, "geom": lv.geom, "iters": out["iters"],
                  "time": out["solve_time"], "method": solver.name,
                  "final_kkt": hist["kkt"][-1] if hist["len"] else None,
                  "D": lv.D, "E": lv.E, "build_s": build_s}
        if hasattr(solver, "stats"):
            # the device driver's: host syncs and checks of the level loop,
            # graph captures and replays, the host's seconds in prepare,
            # first runs, captures and finish
            report["driver"] = dict(solver.stats)
        if profile:
            # per-phase times on the level's final state (the reference's
            # record_time, ``solver_socp_inPALM.m:339-341``); a phase that
            # fails raises
            report["phases"] = profile_phases(
                solver.k, solver.k.prep(lv.as_dict(), 1.0), iters=20)
        level_reports.append(report)
        if verbose:
            print(f"Completed level {lev + 1}/{level_n} "
                  f"(nt={lv.geom.nt}, space={lv.geom.space}): "
                  f"{out['iters']} iters, {out['solve_time']:.2f}s, "
                  f"final KKT max={np.max(hist['kkt'][-1][[0, 2, 5]]):.2e}")

        if lev < level_n - 1:
            time_limit -= out["solve_time"]
            sigma = 10.0 ** (math.log10(sigma * out["sigma_out"]) / 2.0)
            last_kkt = hist["kkt"][-1]
            with span("level.prolong", spans):
                lv = _jump_next_level(lv, rho0s[lev + 1], rho1s[lev + 1],
                                      nts[lev + 1], dtype, weights[lev + 1])

    refine_tol = opts.get("refine_tol")
    if refine_tol is not None:
        # mixed-precision refinement (``dotsocp_tpu/multilevel/solve.py:
        # 681-819``): continue the finest level in float64 to a tighter
        # tolerance. The options are checked where they are read.
        refine_tol = float(refine_tol)
        refine_dtype = _refine_dtype(opts.get("refine_dtype", torch.float64))
        refine_method = str(opts.get("refine_method", method))
        methods_ok = WDOT_METHODS if weighted else METHODS
        if refine_method not in methods_ok:
            raise ValueError(
                f"refine_method {refine_method!r} not in {methods_ok}")
        split = _refine_split(opts.get("refine_dct_split", "auto"))
        time_limit -= out["solve_time"]
        sigma = 10.0 ** (math.log10(sigma * out["sigma_out"]) / 2.0)
        sigma *= float(opts.get("refine_sigma_scale", 1.0))
        tau = float(opts.get("refine_tau", tau))
        last_kkt = hist["kkt"][-1]
        # same-geometry warm restart: keep (phi, q, z, alpha, beta), rebuild
        # c in the level's dtype (recover_org_var does not unscale it), then
        # InitialScaling with E2 feedback; the solver's prep casts to
        # refine_dtype
        with span("level.scaling", spans):
            lv.c = make_c(lv.geom, rho0s[-1], rho1s[-1])
            initial_scaling(lv, scaling, last_kkt, prev_e2)
        # one phase: the JAX package's second phase follows only its
        # split-f32 DCT, which the port does not have
        o = SolveOptions(tol=refine_tol, maxit=maxit, sigma=sigma, tau=tau,
                         time_limit=max(time_limit, 0.0), scaling=scaling,
                         check_step_by_step=check_sbs,
                         check_prim_dual_feas=check_pdf,
                         restart=int(opts.get("restart", 100)),
                         rho=float(opts.get("rho", 2.0)),
                         debug_nans=debug_nans,
                         label=f"level {level_n} (f64 refine)")
        # the tail takes the driver rule and the chunk options, and no
        # checkpoint (as the JAX package's tail)
        with span("level.build", spans):
            solver = _build_solver(refine_method, lv, o, device,
                                   refine_dtype, theta, dct_split=split,
                                   driver=driver, device_kw=device_kw,
                                   mesh=mesh, reuse=reuse)
        with span("level.loop", spans):
            hist, out = solver.solve(lv.as_dict())
        hist["method"] = solver.name + (
            " (f64 refine, IR-DCT)" if split else " (f64 refine)")
        hists.append(hist)
        with span("level.recover", spans):
            recover_org_var(lv, out)
        level_reports.append({
            "level": level_n, "geom": lv.geom, "iters": out["iters"],
            "time": out["solve_time"], "method": hist["method"],
            "refine": True,
            "final_kkt": hist["kkt"][-1] if hist["len"] else None})
        if hasattr(solver, "stats"):
            level_reports[-1]["driver"] = dict(solver.stats)
        if verbose:
            print(f"f64 refine (tol={refine_tol:g}, 1 phase(s)): "
                  f"{out['iters']} iters, {out['solve_time']:.2f}s, final KKT "
                  f"max={np.max(hist['kkt'][-1][[0, 2, 5]]):.2e}")

    total_time = time.monotonic() - t_start
    with span("level.recover", spans):
        rho, Es, q0, bs, mass_ok = recover_solution(lv)
    if not mass_ok and verbose:
        print("WARNING: mass conservation violation exceeds 1e-2")
    if verbose:
        print("spans: " + ", ".join(f"{k[:-2]} {1e3 * v:.1f} ms"
                                    for k, v in spans.items()))

    output = {"rho": rho, "E": Es, "q0": q0, "b": bs, "mass_ok": mass_ok,
              "levels": level_reports, "total_time": total_time,
              "spans": spans, "kkt_names": KKT_LEGEND}
    if lv.geom.ndim_space == 2:
        # space = (ny, nx): axis 0 = y, axis 1 = x
        output["Ey"], output["Ex"] = Es[0], Es[1]
        output["by"], output["bx"] = bs[0], bs[1]
    elif lv.geom.ndim_space == 1:
        output["Ex"] = Es[0]
        output["bx"] = bs[0]

    run_hist_ml = _cat_hist(hists)
    run_hist_ml["method"] = hists[-1]["method"]
    run_hist_ml["kktNames"] = KKT_LEGEND
    return output, run_hist_ml, hists[-1]
