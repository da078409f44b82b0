"""Solver state, per-level constants, and the per-level compute kernels;
port of ``dotsocp_tpu/algorithms/core.py`` (``Kernels`` with
``InPALMKernels`` folded in: inPALM, and ALG2 as tau = 1), weighted or
not. The other algorithms subclass it in :mod:`.variants`.

A weighted level (the obstacle problems, ``solver_wsocp_inPALM.m``) carries
the weight w in the flat layout. It enters the phi-step rhs
D A^T(w q - alpha) + c, the q-step (w (A phi + alpha) + BF^T(z + beta)) /
(base + w^2) and its multiplier A phi - w q, and the KKT battery; the z-
and beta-steps, and so the x_step, cx, z_step and beta_step kernels, are
those of the unweighted problem (``dotsocp_tpu/algorithms/core.py:156-168,
258-313``).

Two paths run the iteration after the phi-step on hand-written kernels
(``ops/fused_step.py``): the CA x-carry segment of inPALM / ALG2
(``segment_impl``: x_step, then qx_step + cx_step per iteration), and the
single step ``_step`` (z_step, q_step, beta_step), which ``run_one``, the
profiler and sGS-inPALM's step run. The lockstep fleet
(``parallel/batch.py``) runs the CA segment over B instances stacked on a
leading axis (``segment_batched``: the batched forms of the x-carry
kernels, the phi-step's rhs and DCT over the whole stack). The phi-step's
right-hand side D A^T (w q - alpha) + c is one kernel on either path, and
in every variant's step (``fused_step.phi_rhs``, from ``_rhs``). So are
the sums of every variant's KKT check (``fused_step.kkt_sums``, from
``_kkt_parts``); ``_kkt_parts_plain`` forms them on the CPU, in float64
and on the halo engine.

The iteration state lives on the caller's device. Under the host driver
the level scalars (sigma, cScale, dScale, norm_c, norm_d, D, E) are
Python floats on the host: only its events change them (the sigma update
and the rescale, which read norms back anyway), so every kernel gets
sbf = E/D, sd = E/dScale, tau and D by value and no step copies anything
from the device. The device driver (``device_driver.py``) keeps sigma,
cScale, dScale, norm_c, norm_d and sigmaScale as 0-d tensors in the
state's dtype on the card instead, as the JAX package keeps them traced,
and the same methods run on them (sd is then a tensor the kernels read
from memory). E and every value derived from it are tensors there too
(:class:`EScalars`, the state's ``ev``): a cached driver's captured
graphs serve the next problem, whose E differs from level 2 on (the E2
feedback), as the JAX package traces E. Each holds the value the host
driver passes: formed in double on the host from (D, E) and rounded once
to the state's dtype, so the two forms compute alike. D stays a float:
it depends only on the geometry and the weight, which key the solver
cache (``multilevel/solve.py``). (In f32 runs the two forms differ by at
most 1 ulp in the scalars the device driver updates on the card.)

The variables alpha, beta, c are stored pre-divided by sigma, exactly like
the reference (``solver_socp_inPALM.m:102-104``).

On one process every level runs the flat engine (``ops/engine.OpsFlat``).
The JAX package's second engine of one process, its shaped ``"3d"``
layout, has its counterpart in ``ops/engine.Ops3D``, which the tests and
the native check hold the flat engine to; a solve asked for ``"3d"`` runs
flat (:func:`warn_single_process_layout`) and takes the same iterations.
Which version of a step each wrapper runs, kernel or plain, is decided in
one place, ``fused_step.on_kernel``.

Under a mesh (``LevelConfig.mesh``, ``dotsocp_tpu/algorithms/core.py:
114-149``) the level's engine is the halo engine and each tensor is one
rank's block (``ops/halo_engine.py``). The steps whose kernels read
neighbouring cells (the single-step and x-carry kernels, the sGS sweep)
run their plain versions on the block (``fused_step.on_kernel``), as the
JAX package launches no Pallas kernel there
(``dotsocp_tpu/multilevel/solve.py:228``); the cone projection, pointwise,
runs its kernel on the block as on one process.
Every norm and dot product of a check sums its block's part over the mesh,
all of them in one collective (``_mesh_sums``), so every rank holds the
same KKT values. A fleet's level runs on its batch row of the mesh
(``parallel/sharding.Mesh.row``): its batched step is the variant's own
step on the whole stack of the rank's blocks (the halo engine takes
leading axes), and a check sums every instance's parts in one collective
(``kkt_batched``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.cone import proj_soc
from ..ops.engine import _INV_SQRT2, base_values, diag_values, make_ops
from ..ops.fused_step import (WeightedDinv, beta_step, beta_step_plain,
                              cx_final, cx_final_batched, cx_step,
                              cx_step_batched, kkt_sums, on_kernel, phi_rhs,
                              phi_rhs_plain, q_step, q_step_plain, qx_step,
                              qx_step_batched, select_instance, times_dinv,
                              weighted_dinv, x_step, x_step_batched, z_step,
                              z_step_plain)
from ..ops.geometry import Geometry
from ..ops.staggered import Staggered
from ..utils.norms import sqsum

# the KKT battery's scalars computed on the device, packed after the 7 + 5
# residuals into one vector, so a check costs one device-to-host transfer;
# the state's own scalars are host floats and are added after the transfer
DEVICE_SCALARS = ["priVal", "dualVal", "pdGap", "normPhi", "normQ", "normZ",
                  "normAlpha", "normBeta", "normAphi"]
HOST_SCALARS = {"norm_c_state": "norm_c", "cScale": "cScale",
                "dScale": "dScale", "sigma": "sigma", "D": "D", "E": "E"}


def pack_kkt(res: dict) -> torch.Tensor:
    parts = [res["kkt_org"], res["kkt"],
             torch.stack([res[k] for k in DEVICE_SCALARS])]
    if "kkt_sgs_blocks" in res:
        parts.append(res["kkt_sgs_blocks"][None])
    return torch.cat(parts)


def unpack_kkt(vec) -> dict:
    vec = np.asarray(vec)
    out = {"kkt_org": vec[:7], "kkt": vec[7:12]}
    for i, k in enumerate(DEVICE_SCALARS):
        out[k] = vec[12 + i]
    if vec.shape[0] > 12 + len(DEVICE_SCALARS):
        out["kkt_sgs_blocks"] = vec[12 + len(DEVICE_SCALARS)]
    return out


@dataclasses.dataclass
class SolverState:
    """Per-iteration state. Tensors are in the flat internal layout; inside
    a segment ``z`` holds x = z + beta."""

    phi: torch.Tensor       # (nt, S)
    q: Staggered
    z: torch.Tensor         # (C, nt-1, S)
    alpha: Staggered        # stored as alpha / sigma
    beta: torch.Tensor      # stored as beta / sigma
    c: torch.Tensor         # scaled c / sigma
    sigma: float
    cScale: float
    dScale: float
    norm_c: float
    norm_d: float
    sigmaScale: float       # product of sigma rescale factors
    D: float
    E: float
    # the device driver's E-derived scalars on the card (E is then ev.E);
    # None: the host driver's floats, from which each step forms them
    ev: Optional["EScalars"] = None

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "SolverState":
        """Deep copy of the tensors (kernels update some in place)."""
        return self.replace(phi=self.phi.clone(), q=self.q.clone(),
                            z=self.z.clone(), alpha=self.alpha.clone(),
                            beta=self.beta.clone(), c=self.c.clone())


@dataclasses.dataclass
class EScalars:
    """The E-derived scalars of the device driver's state: 0-d views into
    one vector ``vec`` on the state's device, in its dtype, each the value
    the host driver passes by value (formed in double, rounded once), so
    that a captured CUDA graph reads them from memory. ``dinv`` is what the
    q-step takes: the inverse diagonal's (interior, boundary-slab) values,
    or a weighted level's :class:`~..ops.fused_step.WeightedDinv`, whose
    ``base`` values are views into ``vec`` and whose ``inv`` a buffer of
    its own. ``inv_E`` is 1/E formed in the dtype, as the card's PyTorch
    divides a tensor by a host float (a product with its reciprocal)."""

    vec: torch.Tensor       # (E, E/D, E/D/sqrt2, dinv or base x2, 1/E)
    E: torch.Tensor
    sbf: torch.Tensor       # E / D
    sv: torch.Tensor        # E / D / sqrt2
    dinv: object
    inv_E: torch.Tensor

    def tensors(self) -> list:
        out = [self.vec]
        if isinstance(self.dinv, WeightedDinv):
            out += self.dinv.inv.blocks()
        return out


# the state's scalars a batched state holds as (B,) tensors
BATCH_SCALARS = ("sigma", "cScale", "dScale", "norm_c", "norm_d",
                 "sigmaScale")


def stack_fields(states, fields) -> dict:
    """The ``fields`` of per-instance states, each stacked on a leading
    axis (a Staggered field block by block)."""
    out = {}
    for f in fields:
        parts = [getattr(st, f) for st in states]
        if isinstance(parts[0], Staggered):
            out[f] = Staggered.stack(parts)
        else:
            out[f] = torch.stack(parts)
    return out


def select_stack(active, new, old):
    """Each instance's ``new`` where ``active`` (B,), else ``old``: tensors
    with a leading (B,) axis, or Staggered fields of them."""
    if isinstance(new, Staggered):
        return new.map(lambda n, o: select_stack(active, n, o), old)
    return torch.where(active.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                       old)


def instance(s: SolverState, b: int) -> SolverState:
    """Instance b of a batched state as views (no copy): its tensors and
    its scalars as 0-d tensors; D and E are the level's."""
    return s.replace(phi=s.phi[b], q=s.q.at(b), z=s.z[b], alpha=s.alpha.at(b),
                     beta=s.beta[b], c=s.c[b],
                     **{f: getattr(s, f)[b] for f in BATCH_SCALARS})


@dataclasses.dataclass(frozen=True)
class LevelConfig:
    """Static configuration of one level's kernels. D and E are defaults
    for bookkeeping; the kernels read the state's copies (set by ``prep``)."""

    geom: Geometry
    D: float
    E: float
    device: str
    tau: float = 1.9
    dtype: torch.dtype = torch.float32
    # the f64 strategy of the phi-step DCT solve (``ops/poisson.SPLITS``):
    # False = matmuls in ``dtype``; "ir" / "ir1" = f32 transforms with
    # f64-residual refinement (two rounds / one)
    dct_split: object = False
    # the rank's mesh (``parallel/sharding.Mesh``): the level runs on the
    # halo engine, one block a rank; None: one process, the flat engine
    mesh: object = None


def check_mesh_opts(opts: dict, where: str) -> None:
    """Under a mesh that splits the grid the port runs the halo engine:
    layout "flat" and "3d" raise, and so does ``use_pallas=True``, each
    with the reason."""
    layout = opts.get("layout", "auto")
    if layout in ("flat", "3d"):
        raise ValueError(
            f"layout={layout!r} under a mesh ({where}): the JAX package then "
            f"runs its shaped engine and lets XLA's GSPMD partitioner split "
            f"it, which has no PyTorch counterpart; the port's partitioner is "
            f"the halo engine (layout 'auto' or 'halo')")
    if opts.get("use_pallas", "auto") is True:
        raise NotImplementedError(
            f"use_pallas=True under a mesh ({where}): the kernels that read "
            f"neighbouring cells (the single-step and x-carry kernels, the "
            f"sGS sweep) have no halo-padded route yet (ROADMAP.md queue 6 "
            f"item 10), so under a mesh they run plain on each rank's block "
            f"and only the cone projection runs its kernel; pass "
            f"use_pallas='auto'")


def warn_single_process_layout(opts: dict, stacklevel: int) -> None:
    """On one process every level runs the flat engine: layout "halo"
    (which needs a mesh that splits the grid, as in the JAX package) and
    "3d" (whose shaped engine takes the flat engine's iterations, more
    slowly, and is kept as its test oracle only) warn and run flat.
    ``stacklevel`` as the caller would pass it to ``warnings.warn``."""
    layout = opts.get("layout")
    if layout == "halo":
        why = "requires a mesh that splits the grid (opts={'mesh': ...})"
    elif layout == "3d":
        why = ("runs no engine of its own: the shaped engine takes the flat "
               "engine's iterations, more slowly")
    else:
        return
    warnings.warn(f"layout={layout!r} {why}; falling back to the "
                  f"single-process 'flat' layout", stacklevel=stacklevel + 1)


class Kernels:
    """One level's compute: the inPALM step, the CA x-carry segment, the
    KKT battery and the host-driven state transforms."""

    def __init__(self, cfg: LevelConfig, weight: Optional[Staggered] = None):
        self.cfg = cfg
        self.geom = cfg.geom
        self.ops = make_ops(cfg.geom, cfg.dtype, cfg.device, cfg.mesh)
        # unit-D build: the solve multiplies by 1/D^2 at use time
        self.poisson = self.ops.make_poisson(1.0, split=cfg.dct_split)
        # the shaped weight of a weighted level, flat, in the level's dtype
        self.weight = None
        if weight is not None:
            self.weight = self.ops.weight_to_internal(
                weight.to(dtype=cfg.dtype, device=self.ops.device))
        self._wdinv = None  # (D, E) -> WeightedDinv, see _diag_inv

    def _w(self, x: Staggered) -> Staggered:
        """Multiply by the diagonal weight D_w (identity when unweighted)."""
        return x if self.weight is None else self.weight * x

    # -- the E-derived scalars -------------------------------------------
    # Each step forms them from the host driver's floats, or reads the
    # device driver's tensors (``s.ev``), which hold the same values.
    @staticmethod
    def _sbf(s: SolverState):
        return s.E / s.D if s.ev is None else s.ev.sbf

    @staticmethod
    def _sv(s: SolverState):
        """sbf / sqrt2 as the host rounds it; None: the operator forms it
        from the float sbf."""
        return None if s.ev is None else s.ev.sv

    @staticmethod
    def _sd(s: SolverState):
        """sd = E / dScale; with the device driver's tensors as PyTorch
        divides the float E by the tensor dScale: dScale's reciprocal
        times E."""
        if s.ev is None:
            return s.E / s.dScale
        return s.dScale.reciprocal() * s.ev.E

    @staticmethod
    def _over_E(s: SolverState, x):
        """x / E for a 0-d tensor x, rounded as with the host's float E:
        on the card PyTorch multiplies by 1/E formed in the dtype, on the
        CPU it divides."""
        if s.ev is None:
            return x / s.E
        return x * s.ev.inv_E if x.is_cuda else x / s.ev.E

    def _bfd(self, s: SolverState, q: Staggered):
        return self.ops.bfd(q, self._sbf(s), self._sd(s), self._sv(s))

    def _bfd_T(self, s: SolverState, x):
        return self.ops.bfd_T(x, self._sbf(s), self._sv(s))

    def e_scalars(self, D: float, E: float) -> EScalars:
        """The device driver's :class:`EScalars` for the level's (D, E): the
        values the host driver forms, in double, rounded once to the
        level's dtype (one copy to the card)."""
        dtype = self.cfg.dtype
        sbf = E / D
        if self.weight is None:
            d_in, d_bd = diag_values(D, E)
            diag = (1.0 / d_in, 1.0 / d_bd)
        else:
            diag = base_values(D, E)
        npd = np.float64 if dtype == torch.float64 else np.float32
        inv_E = float(npd(1.0) / npd(E))
        vec = torch.tensor([E, sbf, sbf * _INV_SQRT2, *diag, inv_E],
                           dtype=torch.float64).to(self.ops.device, dtype)
        E_t, sbf_t, sv_t, d0, d1, inv_t = vec.unbind(0)
        dinv = (d0, d1)
        if self.weight is not None:
            inv = weighted_dinv(self.ops, self.weight, D, E).inv
            dinv = WeightedDinv(w=self.weight, base=dinv, inv=inv)
        return EScalars(vec=vec, E=E_t, sbf=sbf_t, sv=sv_t, dinv=dinv,
                        inv_E=inv_t)

    def _diag_inv(self, s: SolverState):
        """1 / diag(D_w*D_w + (E/D)^2 F*B*BF): unweighted its (interior,
        boundary-slab) values; weighted a :class:`WeightedDinv`, formed once
        for the level's (D, E) (they change only between levels); the
        device driver's from its :class:`EScalars`."""
        if s.ev is not None:
            return s.ev.dinv
        if self.weight is None:
            d_in, d_bd = diag_values(s.D, s.E)
            return 1.0 / d_in, 1.0 / d_bd
        if self._wdinv is None or self._wdinv[0] != (s.D, s.E):
            self._wdinv = ((s.D, s.E),
                           weighted_dinv(self.ops, self.weight, s.D, s.E))
        return self._wdinv[1]

    @property
    def fast_dct(self) -> bool:
        """True when the phi-step's DCT solve takes the FFT route on some
        axis (``ops/poisson.fast_axis``); the halo engine's solve has no
        FFT route."""
        return bool(getattr(self.poisson, "fast_axes", ()))

    @property
    def dct_kernel(self) -> bool:
        """True when the phi-step's DCT solve runs the matrix route's
        hand-written passes (``ops/poisson.dense_route``) on the level's
        state; the halo engine's solve has no passes."""
        on = getattr(self.poisson, "on_passes", None)
        return on is not None and on(self.cfg.dtype, self.ops.device)

    def _poisson_solve(self, s: SolverState, rhs):
        """phi-step DCT solve of D^2 A^T A phi = rhs."""
        return self.poisson.solve(rhs, scale=1.0 / (s.D * s.D))

    def _rhs(self, s: SolverState, plain: bool = False):
        """phi-step rhs: D A^T (w q - alpha) + c, ``phi_rhs`` (one launch
        on the kernel's route, a stack of instances too), or with
        ``plain`` its plain version."""
        rhs = phi_rhs_plain if plain else phi_rhs
        return rhs(self.ops, s.q, s.alpha, s.c, s.D, self.weight)

    # -- core iteration --------------------------------------------------
    def _step(self, s: SolverState) -> SolverState:
        """One inPALM iteration (``solver_socp_inPALM.m:192-216``): the
        phi-step, then the z-step, the q-step with the alpha multiplier and
        the beta multiplier on the single-step kernels; port of
        ``dotsocp_tpu/algorithms/core.py:224-247`` (``_step_fused``). On
        the CPU the wrappers run their plain versions, which compose to the
        JAX plain ``_step`` (:198-222) operation for operation. Every
        output is a fresh tensor: ``s`` is left as it was."""
        return self._step_from_phi(s, self._poisson_solve(s, self._rhs(s)))

    def _step_plain(self, s: SolverState) -> SolverState:
        """:meth:`_step` from the kernels' plain versions, on any device:
        the reference that tests and ``chip_smoke.py`` hold the kernels'
        step and segment against."""
        return self._step_from_phi(
            s, self._poisson_solve(s, self._rhs(s, plain=True)), plain=True)

    def run_one(self, s: SolverState) -> SolverState:
        """One iteration, the single-step entry point (the JAX
        ``run_one``); ``s`` is left as it was."""
        return self._step(s)

    def _step_from_phi(self, s: SolverState, phi,
                       plain: bool = False) -> SolverState:
        """The inPALM iteration after its phi-step: z-step, q-step and the
        multipliers (sGS-inPALM shares it), through the kernels' wrappers
        (each on its route) or, with ``plain``, their plain versions."""
        zs, qs, bs = ((z_step_plain, q_step_plain, beta_step_plain) if plain
                      else (z_step, q_step, beta_step))
        ops = self.ops
        tau = self.cfg.tau
        sbf, sd, sv = self._sbf(s), self._sd(s), self._sv(s)
        z = zs(ops, s.q, s.beta, sbf, sd, sv=sv)
        q, alpha = qs(ops, phi, z, s.beta, s.alpha, self._diag_inv(s), s.D,
                      sbf, tau, sv=sv)
        beta = bs(ops, s.beta, z, q, sbf, sd, tau, sv=sv)
        return s.replace(phi=phi, q=q, z=z, alpha=alpha, beta=beta)

    def _mesh_sums(self, parts: dict) -> dict:
        """``parts``, 0-d sums over the rank's block, each summed over the
        mesh, all in one collective (on one process the identity)."""
        tot = self.ops.psum(torch.stack(list(parts.values())))
        return dict(zip(parts, tot.unbind(0)))

    def _norms_of(self, *xs) -> list:
        """sqrt(h) ||x|| over the whole field, for each of ``xs``."""
        tot = self._mesh_sums({i: sqsum(x) for i, x in enumerate(xs)})
        return [torch.sqrt(self.geom.h * tot[i]) for i in range(len(xs))]

    def _q_solve(self, s: SolverState, tmp_q: Staggered,
                 q2: Staggered) -> Staggered:
        """The q-step: (w (tmp_q + alpha) + q2) * diag^-1."""
        return times_dinv(self.ops, self._w(tmp_q + s.alpha) + q2,
                          self._diag_inv(s))

    # -- CA-fused x-carry segment ----------------------------------------
    def _fresh_x(self, s: SolverState):
        """x = proj_soc(bfd(q) - beta) + beta for the current (q, beta)."""
        return x_step(self.ops, s.q, s.beta, self._sbf(s), self._sd(s),
                      sv=self._sv(s))

    def _step_fused_x(self, s: SolverState, final: bool) -> SolverState:
        """One x-carry iteration (``s.z`` holds x). ``final=True`` emits the
        boundary state of the plain path: beta' from the multiplier step
        and z = the value this iteration's q-step consumed."""
        sbf, sd, sv = self._sbf(s), self._sd(s), self._sv(s)
        tau = self.cfg.tau
        phi = self._poisson_solve(s, self._rhs(s))
        q, alpha = qx_step(self.ops, phi, s.z, s.alpha, self._diag_inv(s),
                           s.D, sbf, tau, sv=sv)
        step = cx_final if final else cx_step
        beta, znew = step(self.ops, s.beta, s.z, q, sbf, sd, tau, sv=sv)
        return s.replace(phi=phi, q=q, z=znew, alpha=alpha, beta=beta)

    @property
    def segment_ca(self) -> bool:
        """True when segments run the x-carry kernels: the subclass has not
        replaced the inPALM step (PALM and the acc and sGS variants run
        their own step in a plain loop), and the level runs on one process
        (under a mesh the JAX package's segment is its plain step loop)."""
        return type(self)._step is Kernels._step and self.ops.mesh is None

    def segment_impl(self, s: SolverState, k: int) -> SolverState:
        """k event-free iterations. inPALM / ALG2: one x-step prologue,
        k-1 x-carry CA iterations, one boundary iteration restoring the
        (z, beta) state of the plain path; on CUDA the kernels update
        alpha, beta and the z slot in place, so ``s`` is consumed. Other
        variants: k of their own steps."""
        if not self.segment_ca:
            for _ in range(k):
                s = self._step(s)
            return s
        if k < 1:
            return s
        s = s.replace(z=self._fresh_x(s))
        for _ in range(k - 1):
            s = self._step_fused_x(s, final=False)
        return self._step_fused_x(s, final=True)

    def run_segment(self, s: SolverState, k: int) -> SolverState:
        return self.segment_impl(s, int(k))

    # -- the batched CA segment (the lockstep fleet) -------------------------
    # ``s`` holds B instances: every tensor with a leading (B,) axis, the
    # scalars sigma .. sigmaScale as (B,) tensors, D and E the level's
    # floats (the fleet shares its geometry, so its D and E). ``active`` is
    # a (B,) bool tensor: an inactive instance's fields are left exactly as
    # they were, phi included (the counterpart of the JAX package's
    # ``_tree_where(ls.done, ls.s, s_new)``, ``parallel/batch.py:225``).

    def _fresh_x_batched(self, s: SolverState, active):
        """x = proj_soc(bfd(q) - beta) + beta for each active instance,
        into the z slot (on CUDA in place)."""
        return x_step_batched(self.ops, s.q, s.beta, s.E / s.D,
                              s.E / s.dScale, active, s.z)

    def _step_fused_x_batched(self, s: SolverState, final: bool,
                              active) -> SolverState:
        """One x-carry iteration of every active instance (``s.z`` holds
        x): the phi-step over the stack, then the batched qx and cx (or
        cx_final) kernels, which write q', alpha', beta' and the z slot
        into the state's buffers. phi, which no iteration reads, is kept
        from the boundary iteration only, selected where ``active``."""
        sbf = s.E / s.D
        sd = s.E / s.dScale
        tau = self.cfg.tau
        phi = self._poisson_solve(s, self._rhs(s))
        q, alpha = qx_step_batched(self.ops, phi, s.z, s.alpha, s.q,
                                   self._diag_inv(s), s.D, sbf, tau, active)
        step = cx_final_batched if final else cx_step_batched
        beta, znew = step(self.ops, s.beta, s.z, q, sbf, sd, tau, active)
        if final:
            keep = active.reshape((-1,) + (1,) * (phi.ndim - 1))
            phi = torch.where(keep, phi, s.phi)
        else:
            phi = s.phi
        return s.replace(phi=phi, q=q, z=znew, alpha=alpha, beta=beta)

    def _step_batched(self, s: SolverState, active) -> SolverState:
        """One step of the variant's own ``_step`` on each instance, the
        result selected where ``active``: plain PyTorch, as the JAX package
        runs PALM's step in jnp. On one process (PALM) on each instance's
        view; under a mesh (every method) on the whole stack of blocks at
        once, sd broadcast per instance, so that one halo exchange carries
        every instance."""
        fields = ("phi", "q", "z", "alpha", "beta")
        if self.ops.mesh is not None:
            lead = (-1,) + (1,) * (s.q.q0.ndim - 1)
            new = self._step(s.replace(dScale=s.dScale.reshape(lead)))
            return s.replace(**{f: select_stack(active, getattr(new, f),
                                                getattr(s, f))
                                for f in fields})
        steps = []
        for b in range(s.phi.shape[0]):
            cur = instance(s, b)
            new = self._step(cur)
            steps.append(cur.replace(**{
                f: select_instance(active, b, getattr(new, f),
                                   getattr(cur, f)) for f in fields}))
        return s.replace(**stack_fields(steps, fields))

    def segment_batched(self, s: SolverState, k: int,
                        active) -> SolverState:
        """k event-free iterations of a stack of instances, the active ones
        advanced and the others left as they were (the JAX package's
        ``jax.vmap(k.segment_impl, in_axes=(0, None))`` under its freeze).
        inPALM / ALG2: one x-step prologue, k-1 x-carry CA iterations and a
        boundary iteration, on the batched kernels (on CUDA in place, so
        ``s`` is consumed); PALM: k of its own steps."""
        if k < 1:
            return s
        if not self.segment_ca:
            for _ in range(k):
                s = self._step_batched(s, active)
            return s
        s = s.replace(z=self._fresh_x_batched(s, active))
        for _ in range(k - 1):
            s = self._step_fused_x_batched(s, False, active)
        return self._step_fused_x_batched(s, True, active)

    # -- diagnostics -----------------------------------------------------
    def _norms(self, s: SolverState) -> dict:
        """Block norms for the dynamic rescaling checks
        (``solver_socp_inPALM.m:139-148``), as 0-d tensors."""
        phi, q, z, alpha, beta = self._norms_of(s.phi, s.q, s.z, s.alpha,
                                                s.beta)
        return {
            "normPhi": phi,
            "normQ": q,
            "normZ": z,
            "normAlpha": s.sigma * alpha,
            "normBeta": s.sigma * beta,
        }

    def norms(self, s: SolverState) -> dict:
        """:meth:`_norms` as Python floats, in one transfer."""
        res = self._norms(s)
        vals = torch.stack(list(res.values())).tolist()
        return dict(zip(res.keys(), vals))

    def _kkt(self, s: SolverState) -> dict:
        """Full KKT battery (``solver_socp_inPALM.m:223-267``). Its sums
        over the rank's block are formed first and summed over the mesh in
        one collective, then combined."""
        return self._kkt_from_sums(s, self._mesh_sums(self._kkt_parts(s)))

    def kkt_batched(self, s: SolverState) -> list:
        """:meth:`_kkt` of every instance of a batched state (one dict an
        instance), the parts of all of them summed over the mesh in one
        collective."""
        views = [instance(s, b) for b in range(s.phi.shape[0])]
        parts = [self._kkt_parts(v) for v in views]
        keys = list(parts[0])
        tot = self.ops.psum(torch.stack([torch.stack([p[k] for k in keys])
                                         for p in parts]))
        return [self._kkt_from_sums(v, dict(zip(keys, row.unbind(0))))
                for v, row in zip(views, tot.unbind(0))]

    # the weighted q-step runs the hand kernels (``qx_step_w``, ``q_step_w``)
    # where the route allows; acc-ADMM's is plain
    weighted_q_kernels = True

    def weighted_on_kernel(self, s: SolverState) -> bool:
        """Whether a weighted level's q-step and phi-step rhs run the hand
        kernels: the level is weighted, its q-step is a kernel one, and
        ``fused_step.on_kernel`` takes the state's tensors and the weight.
        False for an unweighted level."""
        if self.weight is None or not self.weighted_q_kernels:
            return False
        return on_kernel(self.ops, s.phi, *s.q.tensors(), *s.alpha.tensors(),
                         s.c, *self.weight.tensors())

    def kkt_on_kernel(self, s: SolverState) -> bool:
        """Whether the battery's sums of ``s`` run the kernel
        (``fused_step.kkt_sums``): ``fused_step.on_kernel`` of the state's
        tensors and the weight. Off that route (the CPU, float64, the halo
        engine) :meth:`_kkt_parts_plain` runs."""
        w = [] if self.weight is None else self.weight.tensors()
        return on_kernel(self.ops, s.phi, *s.q.tensors(), s.z,
                         *s.alpha.tensors(), s.beta, s.c, *w)

    def _kkt_parts(self, s: SolverState) -> dict:
        """The KKT battery's sums over the rank's block (0-d tensors): one
        pass of ``fused_step.kkt_sums`` where :meth:`kkt_on_kernel`, else
        :meth:`_kkt_parts_plain`; the same keys in the same order."""
        if not self.kkt_on_kernel(s):
            return self._kkt_parts_plain(s)
        return kkt_sums(self.ops, s.phi, s.q, s.z, s.alpha, s.beta, s.c,
                        self.weight, s.D, s.sigma, s.cScale, s.dScale, s.E,
                        None if s.ev is None else s.ev.vec)

    def _kkt_parts_plain(self, s: SolverState) -> dict:
        """The KKT battery's sums over the rank's block (0-d tensors), in
        PyTorch operations: the reference the kernel is held against."""
        ops = self.ops

        tmp_q = s.D * ops.grad(s.phi)
        resi_alpha = tmp_q - self._w(s.q)
        z2 = self._bfd(s, s.q)
        resi_beta = s.z - z2
        q2b = self._bfd_T(s, s.beta)
        d_alpha = self._w(s.alpha)

        fields = {
            "q": s.q, "z": s.z, "aphi": tmp_q, "alpha": s.alpha,
            "beta": s.beta, "fbbeta": q2b, "prim1": resi_alpha,
            "prim2": resi_beta, "dual1": s.D * ops.grad_T(s.alpha) - s.c,
            "dual2": q2b + d_alpha,
            "complem": s.z - proj_soc(s.z - s.sigma * s.beta),
            "phi": s.phi,
        }
        parts = {k: sqsum(x) for k, x in fields.items()}
        parts["pri"] = s.q.dot(s.alpha)
        parts["dual"] = torch.sum(s.c * s.phi)
        parts.update(self._dot_complement(s, d_alpha, z2))
        return parts

    def _kkt_from_sums(self, s: SolverState, tot: dict) -> dict:
        """The KKT battery from its sums over the whole mesh."""
        h = self.geom.h
        d = self.geom.ndim_space
        kkt_const = 1.0

        def nrm(k):
            return torch.sqrt(h * tot[k])

        norm_q = nrm("q")
        norm_z = nrm("z")
        norm_aphi = nrm("aphi")
        norm_alpha = s.sigma * nrm("alpha")
        norm_beta = s.sigma * nrm("beta")
        norm_fbbeta = s.sigma * nrm("fbbeta")

        prim_fea1 = nrm("prim1")
        prim_fea2 = nrm("prim2")
        dual_fea1 = s.sigma * nrm("dual1")
        dual_fea2 = s.sigma * nrm("dual2")
        complem = nrm("complem")

        # the original-DOT complementarity residuals: the face sums add up
        # over the axes after the mesh's sum, each scaled by h
        m_sq = rb_sq = diff_sq = 0.0
        for a in range(d):
            m_sq = m_sq + h * tot[f"m{a}"]
            rb_sq = rb_sq + h * tot[f"rb{a}"]
            diff_sq = diff_sq + h * tot[f"diff{a}"]
        dc = {
            "dotcomplem": nrm("dotcomplem"),
            "normRho": nrm("rho"),
            "norm_rhoFq": nrm("rhoFq"),
            "mRhoB": torch.sqrt(diff_sq),
            "normM": torch.sqrt(m_sq),
            "normRhoB": torch.sqrt(rb_sq),
        }

        E_over_dscale = self._sd(s)
        if self.weight is not None:
            # wdot2d denominator of residual 2 (``solver_wsocp_inPALM.m``)
            denom2 = kkt_const * E_over_dscale + norm_q + norm_z
        else:
            denom2 = kkt_const * E_over_dscale + s.norm_d
        kkt_org = torch.stack([
            prim_fea1 / (kkt_const * s.D / s.dScale + norm_aphi + norm_q),
            prim_fea2 / denom2,
            dual_fea1 / (kkt_const / s.cScale + s.norm_c),
            complem / (kkt_const * E_over_dscale + norm_z + norm_beta),
            dual_fea2 / (kkt_const / s.cScale / s.D + norm_fbbeta + norm_alpha),
            dc["dotcomplem"] / (kkt_const + dc["normRho"] + dc["norm_rhoFq"]),
            dc["mRhoB"] / (kkt_const + dc["normM"] + dc["normRhoB"]),
        ])
        kkt_scp = torch.stack([
            prim_fea1 / (kkt_const + norm_aphi + norm_q),
            prim_fea2 / (kkt_const + s.norm_d),
            dual_fea1 / (kkt_const + s.norm_c),
            complem / (kkt_const + norm_z + norm_beta),
            dual_fea2 / (kkt_const + norm_fbbeta + norm_alpha),
        ])

        scale = s.sigma * s.cScale * s.dScale * h
        pri_val = scale * tot["pri"]
        dual_val = scale * tot["dual"]
        pd_gap = torch.abs(pri_val - dual_val) / (
            1 + torch.abs(pri_val) + torch.abs(dual_val))
        return {
            "kkt_org": kkt_org,
            "kkt": kkt_scp,
            "priVal": pri_val,
            "dualVal": dual_val,
            "pdGap": pd_gap,
            "normPhi": nrm("phi"),
            "normQ": norm_q,
            "normZ": norm_z,
            "normAlpha": norm_alpha,
            "normBeta": norm_beta,
            "normAphi": norm_aphi,
        }

    def kkt(self, s: SolverState) -> dict:
        """:meth:`_kkt` fetched in one transfer, unpacked to numpy, with the
        state's host scalars added under the JAX package's names."""
        out = unpack_kkt(pack_kkt(self._kkt(s)).cpu().numpy())
        out.update({k: getattr(s, f) for k, f in HOST_SCALARS.items()})
        return out

    def _dot_complement(self, s: SolverState, d_alpha: Staggered, z2):
        """The block's sums of squares of the original-DOT complementarity
        residuals (``socp/dot2d/utils/compute_kkt_dot_complement.m``;
        weighted: ``d_alpha`` is D_w alpha), which :meth:`_kkt` sums over
        the mesh and combines."""
        d = self.geom.ndim_space

        rho_t = (s.sigma * s.cScale * s.D) * d_alpha.q0
        b_cols = z2[1:1 + 4 * d]
        rho_fq = (
            rho_t
            + (s.dScale / s.D) * s.q.q0
            + torch.sum(torch.square(self._over_E(s, s.dScale) * b_cols),
                        dim=0) / 4.0
        )
        rho_fq = torch.clamp(rho_fq, min=0.0)
        parts = {"dotcomplem": sqsum(rho_t - rho_fq), "rho": sqsum(rho_t),
                 "rhoFq": sqsum(rho_fq)}

        # rho on time nodes (zero-padded ends), then on faces; flat ghost
        # garbage is annihilated by the ghost-zero face arrays it multiplies
        rho_nodes = self.ops.t_node_interp(rho_t)
        for a in range(d):
            rho_face = self.ops.face_interp(rho_nodes, a)
            rho_b = (s.dScale / s.D) * rho_face * s.q.bs[a]
            m_a = (s.sigma * s.cScale * s.D) * d_alpha.bs[a]
            parts[f"m{a}"] = torch.sum(torch.square(m_a))
            parts[f"rb{a}"] = torch.sum(torch.square(rho_b))
            parts[f"diff{a}"] = torch.sum(torch.square(m_a - rho_b))
        return parts

    # -- host-driven state transforms ------------------------------------
    def sigma_mult(self, s: SolverState, factor: float) -> SolverState:
        """sigma <- sigma * factor: alpha, beta, c are stored pre-divided
        by sigma (``solver_socp_inPALM.m:309-315``)."""
        inv = 1.0 / factor
        return s.replace(alpha=s.alpha * inv, beta=s.beta * inv,
                         c=s.c * inv, sigma=s.sigma * factor)

    # iterate blocks a dynamic rescale divides by d_scale2: exactly those
    # the reference scales, i.e. those consumed before being recomputed.
    # inPALM scales q and z; phi is overwritten by the next phi-step
    # (``solver_socp_inPALM.m:174-178``)
    RESCALED = ("q", "z")

    def rescale(self, s: SolverState, d_scale2: float,
                c_scale2: float) -> SolverState:
        """Dynamic rescaling of the whole iterate
        (``solver_socp_inPALM.m:163-189``); the blocks of ``RESCALED``
        are divided by d_scale2."""
        r = d_scale2 / (c_scale2 * c_scale2)
        return s.replace(
            sigma=s.sigma * (c_scale2 / d_scale2),
            c=s.c * r,
            norm_c=s.norm_c / c_scale2,
            norm_d=s.norm_d / d_scale2,
            alpha=s.alpha * r,
            beta=s.beta * r,
            dScale=s.dScale * d_scale2,
            cScale=s.cScale * c_scale2,
            sigmaScale=s.sigmaScale * (c_scale2 / d_scale2),
            **{b: getattr(s, b) / d_scale2 for b in self.RESCALED},
        )

    def get_sigma(self, s: SolverState) -> float:
        return s.sigma

    # -- lifecycle -------------------------------------------------------
    def prep(self, var: dict, sigma: float) -> SolverState:
        """Iteration state from level variables (already through
        InitialScaling, shaped layout): convert to the flat layout in the
        level's dtype, divide alpha/beta/c by sigma. Every tensor of the
        state is a fresh contiguous buffer: the kernels take contiguous
        tensors, and the caller's arrays survive their in-place updates."""
        ops = self.ops
        cfg = self.cfg
        conv = dict(dtype=cfg.dtype, device=ops.device)
        sigma = float(sigma)

        def fresh(t):
            return t.to(**conv).clone(memory_format=torch.contiguous_format)

        def fresh_stag(st):
            return ops.stag_to_internal(st.to(**conv)).map(fresh)

        s = SolverState(
            phi=fresh(ops.phi_to_internal(var["phi"])),
            q=fresh_stag(var["q"]),
            z=fresh(ops.z_to_internal(var["z"])),
            alpha=fresh_stag(var["alpha"]) / sigma,
            beta=fresh(ops.z_to_internal(var["beta"])) / sigma,
            c=fresh(ops.phi_to_internal(var["c"])) / sigma,
            sigma=sigma,
            cScale=float(var["cScale"]),
            dScale=float(var["dScale"]),
            norm_c=float(var["norm_c"]),
            norm_d=float(var["norm_d"]),
            sigmaScale=1.0,
            D=float(var.get("D", cfg.D)),
            E=float(var.get("E", cfg.E)),
        )
        self._diag_inv(s)  # a weighted level's inverse diagonal, once
        return s

    def finalize(self, s: SolverState, var: dict) -> dict:
        """Write back the iteration variables in the shaped layout
        (``solver_socp_inPALM.m:329-357``): alpha, beta re-multiplied by
        sigma; sigma unwound by sigmaScale."""
        ops = self.ops
        var = dict(var)
        var.update(
            phi=ops.phi_from_internal(s.phi),
            q=ops.stag_from_internal(s.q),
            z=ops.z_from_internal(s.z),
            alpha=ops.stag_from_internal(s.alpha * s.sigma),
            beta=ops.z_from_internal(s.beta * s.sigma),
            c=ops.phi_from_internal(s.c * s.sigma),
            cScale=s.cScale, dScale=s.dScale, norm_c=s.norm_c,
            norm_d=s.norm_d,
        )
        var["sigma_out"] = s.sigma / s.sigmaScale
        return var

