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
kernels, the phi-step's rhs and DCT over the whole stack).

The iteration state lives on the caller's device. Under the host driver
the level scalars (sigma, cScale, dScale, norm_c, norm_d, D, E) are
Python floats on the host: only its events change them (the sigma update
and the rescale, which read norms back anyway), so every kernel gets
sbf = E/D, sd = E/dScale, tau and D by value and no step copies anything
from the device. The device driver (``device_driver.py``) keeps sigma,
cScale, dScale, norm_c, norm_d and sigmaScale as 0-d tensors in the
state's dtype on the card instead, as the JAX package keeps them traced,
and the same methods run on them (sd is then a tensor the kernels read
from memory); D and E stay floats, constant through a level. (In f32 runs
the two forms differ by at most 1 ulp in these scalars.)

The variables alpha, beta, c are stored pre-divided by sigma, exactly like
the reference (``solver_socp_inPALM.m:102-104``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.cone import proj_soc
from ..ops.engine import OpsFlat, diag_values
from ..ops.fused_step import (beta_step, beta_step_plain, cx_final,
                              cx_final_batched, cx_step, cx_step_batched,
                              q_step, q_step_plain, qx_step, qx_step_batched,
                              select_instance, times_dinv, weighted_dinv,
                              x_step,
                              x_step_batched, z_step, z_step_plain)
from ..ops.geometry import Geometry
from ..ops.staggered import Staggered
from ..utils.norms import norm_l2

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

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "SolverState":
        """Deep copy of the tensors (kernels update some in place)."""
        return self.replace(phi=self.phi.clone(), q=self.q.clone(),
                            z=self.z.clone(), alpha=self.alpha.clone(),
                            beta=self.beta.clone(), c=self.c.clone())


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
            out[f] = Staggered(torch.stack([p.q0 for p in parts]),
                               torch.stack([p.bs for p in parts]))
        else:
            out[f] = torch.stack(parts)
    return out


def instance(s: SolverState, b: int) -> SolverState:
    """Instance b of a batched state as views (no copy): its tensors and
    its scalars as 0-d tensors; D and E are the level's."""
    return s.replace(phi=s.phi[b], q=Staggered(s.q.q0[b], s.q.bs[b]),
                     z=s.z[b], alpha=Staggered(s.alpha.q0[b], s.alpha.bs[b]),
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


class Kernels:
    """One level's compute: the inPALM step, the CA x-carry segment, the
    KKT battery and the host-driven state transforms."""

    def __init__(self, cfg: LevelConfig, weight: Optional[Staggered] = None):
        self.cfg = cfg
        self.geom = cfg.geom
        self.ops = OpsFlat(cfg.geom, cfg.dtype, cfg.device)
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

    def _diag_inv(self, s: SolverState):
        """1 / diag(D_w*D_w + (E/D)^2 F*B*BF): unweighted its (interior,
        boundary-slab) values; weighted a :class:`WeightedDinv`, formed once
        for the level's (D, E) (they change only between levels)."""
        if self.weight is None:
            d_in, d_bd = diag_values(s.D, s.E)
            return 1.0 / d_in, 1.0 / d_bd
        if self._wdinv is None or self._wdinv[0] != (s.D, s.E):
            self._wdinv = ((s.D, s.E),
                           weighted_dinv(self.ops, self.weight, s.D, s.E))
        return self._wdinv[1]

    def _poisson_solve(self, s: SolverState, rhs):
        """phi-step DCT solve of D^2 A^T A phi = rhs."""
        return self.poisson.solve(rhs, scale=1.0 / (s.D * s.D))

    def _rhs(self, s: SolverState):
        """phi-step rhs: D A^T (w q - alpha) + c."""
        return s.D * self.ops.grad_T(self._w(s.q) - s.alpha) + s.c

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
        return self._step_from_phi(s, self._poisson_solve(s, self._rhs(s)),
                                   plain=True)

    def run_one(self, s: SolverState) -> SolverState:
        """One iteration, the single-step entry point (the JAX
        ``run_one``); ``s`` is left as it was."""
        return self._step(s)

    def _step_from_phi(self, s: SolverState, phi,
                       plain: bool = False) -> SolverState:
        """The inPALM iteration after its phi-step: z-step, q-step and the
        multipliers (sGS-inPALM shares it), on the kernels or, with
        ``plain``, their plain versions."""
        zs, qs, bs = ((z_step_plain, q_step_plain, beta_step_plain) if plain
                      else (z_step, q_step, beta_step))
        ops = self.ops
        tau = self.cfg.tau
        sbf = s.E / s.D
        sd = s.E / s.dScale
        z = zs(ops, s.q, s.beta, sbf, sd)
        q, alpha = qs(ops, phi, z, s.beta, s.alpha, self._diag_inv(s), s.D,
                      sbf, tau)
        beta = bs(ops, s.beta, z, q, sbf, sd, tau)
        return s.replace(phi=phi, q=q, z=z, alpha=alpha, beta=beta)

    def _q_solve(self, s: SolverState, tmp_q: Staggered,
                 q2: Staggered) -> Staggered:
        """The q-step: (w (tmp_q + alpha) + q2) * diag^-1."""
        return times_dinv(self.ops, self._w(tmp_q + s.alpha) + q2,
                          self._diag_inv(s))

    # -- CA-fused x-carry segment ----------------------------------------
    def _fresh_x(self, s: SolverState):
        """x = proj_soc(bfd(q) - beta) + beta for the current (q, beta)."""
        return x_step(self.ops, s.q, s.beta, s.E / s.D, s.E / s.dScale)

    def _step_fused_x(self, s: SolverState, final: bool) -> SolverState:
        """One x-carry iteration (``s.z`` holds x). ``final=True`` emits the
        boundary state of the plain path: beta' from the multiplier step
        and z = the value this iteration's q-step consumed."""
        sbf = s.E / s.D
        sd = s.E / s.dScale
        tau = self.cfg.tau
        phi = self._poisson_solve(s, self._rhs(s))
        q, alpha = qx_step(self.ops, phi, s.z, s.alpha, self._diag_inv(s),
                           s.D, sbf, tau)
        step = cx_final if final else cx_step
        beta, znew = step(self.ops, s.beta, s.z, q, sbf, sd, tau)
        return s.replace(phi=phi, q=q, z=znew, alpha=alpha, beta=beta)

    @property
    def segment_ca(self) -> bool:
        """True when segments run the x-carry kernels: the subclass has not
        replaced the inPALM step (PALM and the acc and sGS variants run
        their own step in a plain loop)."""
        return type(self)._step is Kernels._step

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
        """One step of the variant's own ``_step`` (PALM) on each
        instance's view, the result selected where ``active``: plain
        PyTorch, as the JAX package runs PALM's step in jnp."""
        fields = ("phi", "q", "z", "alpha", "beta")
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
        h = self.geom.h
        return {
            "normPhi": norm_l2(s.phi, h),
            "normQ": norm_l2(s.q, h),
            "normZ": norm_l2(s.z, h),
            "normAlpha": s.sigma * norm_l2(s.alpha, h),
            "normBeta": s.sigma * norm_l2(s.beta, h),
        }

    def norms(self, s: SolverState) -> dict:
        """:meth:`_norms` as Python floats, in one transfer."""
        res = self._norms(s)
        vals = torch.stack(list(res.values())).tolist()
        return dict(zip(res.keys(), vals))

    def _kkt(self, s: SolverState) -> dict:
        """Full KKT battery (``solver_socp_inPALM.m:223-267``)."""
        geom = self.geom
        ops = self.ops
        h = geom.h
        kkt_const = 1.0

        tmp_q = s.D * ops.grad(s.phi)
        resi_alpha = tmp_q - self._w(s.q)
        z2 = ops.bfd(s.q, s.E / s.D, s.E / s.dScale)
        resi_beta = s.z - z2
        q2b = ops.bfd_T(s.beta, s.E / s.D)
        d_alpha = self._w(s.alpha)

        norm_q = norm_l2(s.q, h)
        norm_z = norm_l2(s.z, h)
        norm_aphi = norm_l2(tmp_q, h)
        norm_alpha = s.sigma * norm_l2(s.alpha, h)
        norm_beta = s.sigma * norm_l2(s.beta, h)
        norm_fbbeta = s.sigma * norm_l2(q2b, h)

        prim_fea1 = norm_l2(resi_alpha, h)
        prim_fea2 = norm_l2(resi_beta, h)
        dual_fea1 = s.sigma * norm_l2(s.D * ops.grad_T(s.alpha) - s.c, h)
        dual_fea2 = s.sigma * norm_l2(q2b + d_alpha, h)
        complem = norm_l2(s.z - proj_soc(s.z - s.sigma * s.beta), h)

        dc = self._dot_complement(s, d_alpha, z2)

        E_over_dscale = s.E / s.dScale
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
        pri_val = scale * s.q.dot(s.alpha)
        dual_val = scale * torch.sum(s.c * s.phi)
        pd_gap = torch.abs(pri_val - dual_val) / (
            1 + torch.abs(pri_val) + torch.abs(dual_val))
        return {
            "kkt_org": kkt_org,
            "kkt": kkt_scp,
            "priVal": pri_val,
            "dualVal": dual_val,
            "pdGap": pd_gap,
            "normPhi": norm_l2(s.phi, h),
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
        """Original-DOT complementarity residuals
        (``socp/dot2d/utils/compute_kkt_dot_complement.m``; weighted:
        ``d_alpha`` is D_w alpha)."""
        geom = self.geom
        h = geom.h
        d = geom.ndim_space

        rho_t = (s.sigma * s.cScale * s.D) * d_alpha.q0
        b_cols = z2[1:1 + 4 * d]
        rho_fq = (
            rho_t
            + (s.dScale / s.D) * s.q.q0
            + torch.sum(torch.square((s.dScale / s.E) * b_cols), dim=0) / 4.0
        )
        rho_fq = torch.clamp(rho_fq, min=0.0)

        dotcomplem = norm_l2(rho_t - rho_fq, h)
        norm_rho = norm_l2(rho_t, h)
        norm_rho_fq = norm_l2(rho_fq, h)

        # rho on time nodes (zero-padded ends), then on faces; flat ghost
        # garbage is annihilated by the ghost-zero face arrays it multiplies
        rho_nodes = self.ops.t_node_interp(rho_t)
        m_sq = rb_sq = diff_sq = 0.0
        for a in range(d):
            rho_face = self.ops.face_interp(rho_nodes, a)
            rho_b = (s.dScale / s.D) * rho_face * s.q.bs[a]
            m_a = (s.sigma * s.cScale * s.D) * d_alpha.bs[a]
            m_sq = m_sq + h * torch.sum(torch.square(m_a))
            rb_sq = rb_sq + h * torch.sum(torch.square(rho_b))
            diff_sq = diff_sq + h * torch.sum(torch.square(m_a - rho_b))
        return {
            "dotcomplem": dotcomplem,
            "normRho": norm_rho,
            "norm_rhoFq": norm_rho_fq,
            "mRhoB": torch.sqrt(diff_sq),
            "normM": torch.sqrt(m_sq),
            "normRhoB": torch.sqrt(rb_sq),
        }

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
            st = ops.stag_to_internal(st.to(**conv))
            return Staggered(fresh(st.q0), fresh(st.bs))

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

