"""Top-level multilevel solver API; port of
``dotsocp_tpu/multilevel/solve.py:462-680`` (``solve_dot``) for the
unweighted problem in 1D and 2D, with every method of the JAX package's
``DOT_METHODS`` (acc-ADMM with theta = 2, its Halpern branch).

``solve_dot(rho0, rho1, nt, level_n, opts, method, device=...)`` builds the
coarse pyramid, runs the algorithm per level with warm-started sigma and E2
feedback, prolongates between levels, and recovers (rho, E, q). The JAX
package's solver cache, prewarm, Pallas size gate, tracing and profiling
options have no counterpart here: eager PyTorch compiles nothing, and the
CUDA kernels run at every size.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..algorithms.core import Kernels, LevelConfig
from ..algorithms.driver import SolveOptions
from ..algorithms.solvers import (AccADMMSolver, AccSgsADMMSolver,
                                  ALG2Solver, InPALMSolver, PALMSolver,
                                  SgsInPALMSolver)
from ..algorithms.variants import (AccADMMKernels, AccSgsADMMKernels,
                                   PALMKernels, SgsKernels)
from ..ops.engine import OpsFlat
from .level import (
    LevelVar,
    initial_scaling,
    initialize,
    recover_org_var,
    recover_solution,
)
from .transfer import prolong_phi, prolong_z_like, restrict_density

METHODS = ("PALM", "inPALM", "ALG2", "acc-ADMM", "sGS-inPALM",
           "acc-sGS-ADMM")

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
ALM_STEPSIZE = 1.9
ALG2_STEPSIZE = 1.0

# options of the JAX solve_dot this port takes, and those that wait in a
# ROADMAP.md queue
KNOWN_OPTS = {"tol", "maxit", "sigma", "time_limit", "scaling",
              "ifCheckStepByStep", "checkPrimDualFeas", "restart", "rho",
              "theta"}
QUEUED_OPTS = {
    "refine_tol": "queue 1 (refine tail)",
    "refine_dtype": "queue 1 (refine tail)",
    "refine_method": "queue 1 (refine tail)",
    "refine_dct_split": "queue 1 (refine tail)",
    "mesh": "queue 1 (multi-device, last)",
    "checkpoint_dir": "queue 1 (the rest: checkpointing)",
}


def _is_sgs(method: str) -> bool:
    return method in ("sGS-inPALM", "acc-sGS-ADMM")


def _check_request(rho0, method, weight, opts):
    if weight is not None:
        raise NotImplementedError(
            "weighted transport waits in ROADMAP.md queue 1 (other "
            "algorithms and the weighted family) and queue 2 (weighted qx)")
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    for key in opts:
        if key in QUEUED_OPTS:
            raise NotImplementedError(
                f"option {key!r} waits in ROADMAP.md {QUEUED_OPTS[key]}")
        if key not in KNOWN_OPTS:
            raise ValueError(f"unknown option {key!r}")
    if float(opts.get("theta", 2.0)) != 2.0:
        raise NotImplementedError(
            "acc-ADMM's Nesterov branch (theta != 2) waits in ROADMAP.md "
            "queue 1 (other algorithms)")
    if np.ndim(rho0) not in (1, 2):
        raise NotImplementedError(
            "3D transport waits in ROADMAP.md queue 1 and queue 2 (3D "
            "kernels)")


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


def _jump_next_level(lv: LevelVar, rho0_f, rho1_f, nt_f: int,
                     dtype) -> LevelVar:
    """Prolongate (phi, beta), build the fine model, and warm-start
    q = A phi, alpha = -(BF)^T beta (``jump_nextLevel.m``). The gradient and
    the BF adjoint go through the flat engine and back: the values equal
    the shaped operators' (``dotsocp_tpu/ops/engine.py:24-26``)."""
    lv_f = initialize(rho0_f, rho1_f, nt_f, dtype=dtype,
                      device=lv.phi.device)
    ops = OpsFlat(lv_f.geom, dtype, lv.phi.device)
    phi_f = prolong_phi(lv.phi.to(dtype))
    beta_f = prolong_z_like(lv.beta.to(dtype))
    lv_f.phi = phi_f
    lv_f.beta = beta_f
    lv_f.q = ops.stag_from_internal(ops.grad(ops.phi_to_internal(phi_f)))
    lv_f.alpha = ops.stag_from_internal(
        ops.bfd_T(ops.z_to_internal(-beta_f), 1.0))
    return lv_f


def _make_solver(method: str, lv: LevelVar, o: SolveOptions, device,
                 dtype):
    """The level solver of ``method`` (``dotsocp_tpu/multilevel/solve.py:
    236-313``, host driver)."""
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=str(device),
                      tau=o.tau, dtype=dtype)
    if method == "inPALM":
        return InPALMSolver(Kernels(cfg), o)
    if method == "ALG2":
        return ALG2Solver(Kernels(cfg), o)
    if method == "PALM":
        return PALMSolver(PALMKernels(cfg), o)
    if method == "acc-ADMM":
        return AccADMMSolver(AccADMMKernels(cfg, o.restart, o.rho), o)
    if method == "sGS-inPALM":
        return SgsInPALMSolver(SgsKernels(cfg), o)
    return AccSgsADMMSolver(AccSgsADMMKernels(cfg, o.restart, o.rho), o)


def solve_dot(
    rho0,
    rho1,
    nt: int,
    level_n: int = 1,
    opts: Optional[dict] = None,
    method: str = "inPALM",
    weight=None,
    *,
    device,
    dtype: torch.dtype = torch.float32,
    verbose: bool = True,
):
    """Multilevel DOT-SOCP solve on ``device`` (required). Returns
    (output, run_hist_ml, run_hist) like the JAX ``solve_dot``.

    output: rho (nt, *space), E (list per axis; Ex/Ey aliases in 2D), q0,
    b (list per axis), mass_ok, per-level reports, total_time.
    """
    opts = dict(opts or {})
    _check_request(rho0, method, weight, opts)
    if not (isinstance(level_n, int) and level_n >= 1):
        raise ValueError("level_n must be a positive integer")
    device = torch.device(device)
    if dtype == torch.float32 and float(opts.get("tol", 1e-4)) < 5e-5 \
            and verbose:
        print("WARNING: float32 stalls around KKT ~1e-4; tolerances below "
              "5e-5 need dtype=torch.float64.")

    sgs_method = _is_sgs(method)
    tol = float(opts.get("tol", 1e-4))
    scaling = bool(opts.get("scaling", True))
    maxit = int(opts.get("maxit", SGS_MAXIT if sgs_method else ADMM_MAXIT))
    sigma = float(opts.get("sigma", 0.1 if sgs_method else 1.0))
    time_limit = float(opts.get("time_limit", 3600.0))
    check_sbs = bool(opts.get("ifCheckStepByStep", False))
    check_pdf = bool(opts.get("checkPrimDualFeas", True))
    if method in ("PALM", "inPALM", "sGS-inPALM"):
        tau = ALM_STEPSIZE
    elif method == "ALG2":
        tau = ALG2_STEPSIZE
    else:
        tau = 1.0  # acc-ADMM multiplier steps are unit

    # tolerance pyramid (``solver_dotsocp2d.m:124-130,166-178``)
    tol_factor = -1.0 if tol > 0.99e-3 else -0.5
    tol_lower = 1e-5 if np.ndim(rho0) == 1 else 1e-4
    rho0s = [None] * level_n
    rho1s = [None] * level_n
    nts = [0] * level_n
    tols = [0.0] * level_n
    rho0s[-1] = torch.as_tensor(rho0, device=device).to(dtype)
    rho1s[-1] = torch.as_tensor(rho1, device=device).to(dtype)
    nts[-1] = nt
    tols[-1] = tol
    for lev in range(level_n - 2, -1, -1):
        nts[lev] = (nts[lev + 1] - 1) // 2 + 1
        tols[lev] = max(tols[lev + 1] * 2.0 ** tol_factor, tol_lower)
        r0 = restrict_density(rho0s[lev + 1])
        r1 = restrict_density(rho1s[lev + 1])
        # renormalize to unit mean (``solver_dotsocp2d.m:174-178``)
        rho0s[lev] = r0 / r0.mean()
        rho1s[lev] = r1 / r1.mean()

    lv = initialize(rho0s[0], rho1s[0], nts[0], dtype=dtype, device=device)
    last_kkt = None
    prev_e2 = None
    hists = []
    level_reports = []
    t_start = time.monotonic()

    for lev in range(level_n):
        initial_scaling(lv, scaling, last_kkt, prev_e2)
        prev_e2 = lv.E2
        o = SolveOptions(tol=tols[lev], maxit=maxit, sigma=sigma, tau=tau,
                         time_limit=time_limit, scaling=scaling,
                         check_step_by_step=check_sbs,
                         check_prim_dual_feas=check_pdf,
                         restart=int(opts.get("restart", 100)),
                         rho=float(opts.get("rho", 2.0)))
        lev_method = method
        if sgs_method and lev < level_n - 1:
            # non-final levels of sGS methods run inPALM
            # (``solver_dotsocp2d.m:209-223``)
            lev_method = "inPALM"
            o.maxit = ADMM_MAXIT
            o.tau = ALM_STEPSIZE
        solver = _make_solver(lev_method, lv, o, device, dtype)
        hist, out = solver.solve(lv.as_dict())
        hist["method"] = solver.name
        hists.append(hist)

        recover_org_var(lv, out)
        level_reports.append({"level": lev + 1, "geom": lv.geom,
                              "iters": out["iters"],
                              "time": out["solve_time"],
                              "method": solver.name,
                              "final_kkt": (hist["kkt"][-1] if hist["len"]
                                            else None)})
        if verbose:
            print(f"Completed level {lev + 1}/{level_n} "
                  f"(nt={lv.geom.nt}, space={lv.geom.space}): "
                  f"{out['iters']} iters, {out['solve_time']:.2f}s, "
                  f"final KKT max={np.max(hist['kkt'][-1][[0, 2, 5]]):.2e}")

        if lev < level_n - 1:
            time_limit -= out["solve_time"]
            sigma = 10.0 ** (math.log10(sigma * out["sigma_out"]) / 2.0)
            last_kkt = hist["kkt"][-1]
            lv = _jump_next_level(lv, rho0s[lev + 1], rho1s[lev + 1],
                                  nts[lev + 1], dtype)

    total_time = time.monotonic() - t_start
    rho, Es, q0, bs, mass_ok = recover_solution(lv)
    if not mass_ok and verbose:
        print("WARNING: mass conservation violation exceeds 1e-2")

    output = {"rho": rho, "E": Es, "q0": q0, "b": bs, "mass_ok": mass_ok,
              "levels": level_reports, "total_time": total_time,
              "kkt_names": KKT_LEGEND}
    if lv.geom.ndim_space == 2:
        # space = (ny, nx): axis 0 = y, axis 1 = x
        output["Ey"], output["Ex"] = Es[0], Es[1]
        output["by"], output["bx"] = bs[0], bs[1]
    else:
        output["Ex"] = Es[0]
        output["bx"] = bs[0]

    run_hist_ml = _cat_hist(hists)
    run_hist_ml["method"] = hists[-1]["method"]
    run_hist_ml["kktNames"] = KKT_LEGEND
    return output, run_hist_ml, hists[-1]
