"""Algorithm variants: PALM, acc-ADMM (Halpern), sGS-inPALM, acc-sGS-ADMM;
port of ``dotsocp_tpu/algorithms/variants.py`` (without the Nesterov
branch of acc-ADMM, which waits in ROADMAP.md queue 1).

Each variant supplies its step order and which iterate blocks a dynamic
rescale divides (``Kernels.RESCALED``: exactly the blocks the reference
scales, i.e. those consumed before being recomputed):

- inPALM (base :class:`~.core.Kernels`): q, z (``solver_socp_inPALM.m:174-178``)
- PALM: phi, z; phi stands in for the reference's ``tmp_q = A*phi`` cache
  (``solver_socp_PALM.m``)
- sGS-inPALM: phi, q (``solver_socp_sGSinPALM.m:185-190``)
- acc-ADMM and acc-sGS-ADMM: phi, q, z, and the Halpern anchors restart
  (``solver_socp_accADMM.m:204-224``)

These variants run their own step in a plain loop (``Kernels.segment_impl``);
the sGS methods' phi-step is one red-black sweep, the CUDA kernel of
``ops/sgs_sweep.py`` on the card. The rest of each step is plain PyTorch,
as the JAX package runs it in jnp. All tensors are in the flat layout
(``ops/engine.py``): the JAX package moves the sGS kernels to its shaped
engine only because its TPU sweep wanted a shaped array, and the flat phi
is that array reshaped.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.cone import proj_soc
from ..ops.sgs import make_sgs
from ..ops.sgs_sweep import rb_sweep
from ..utils.norms import norm_l2
from .core import Kernels, LevelConfig, SolverState

# the iterate blocks the Halpern averaging acts on, in the JAX order
ITERATE = ("phi", "z", "q", "alpha", "beta")


def _iterate(s: SolverState) -> tuple:
    return tuple(getattr(s, f) for f in ITERATE)


def _with_iterate(s: SolverState, t) -> SolverState:
    return s.replace(**dict(zip(ITERATE, t)))


class PALMKernels(Kernels):
    """Exact 2-block proximal ALM: an extra q-step before (phi, z)
    (``solver_socp_PALM.m:196-218``)."""

    RESCALED = ("phi", "z")

    def _step(self, s: SolverState) -> SolverState:
        ops = self.ops
        tau = self.cfg.tau
        sbf = s.E / s.D
        sd = s.E / s.dScale
        # step q0: uses A*phi from the previous iteration
        tmp_q = s.D * ops.grad(s.phi)
        q2 = ops.bfd_T(s.z + s.beta, sbf)
        q = self._q_solve(s, tmp_q + s.alpha + q2)
        # step phi
        phi = self._poisson_solve(s, s.D * ops.grad_T(q - s.alpha) + s.c)
        # step z (z2 refreshed from the q0-step's q)
        z = proj_soc(ops.bfd(q, sbf, sd) - s.beta)
        # step q (second)
        tmp_q = s.D * ops.grad(phi)
        q2 = ops.bfd_T(z + s.beta, sbf)
        q = self._q_solve(s, tmp_q + s.alpha + q2)
        # multipliers
        z2 = ops.bfd(q, sbf, sd)
        return s.replace(phi=phi, q=q, z=z,
                         alpha=s.alpha + tau * (tmp_q - q),
                         beta=s.beta + tau * (z - z2))

    def prep(self, var: dict, sigma: float) -> SolverState:
        s = super().prep(var, sigma)
        # initial z = BFd(A phi) (``solver_socp_PALM.m:136-138``)
        tmp_q = s.D * self.ops.grad(s.phi)
        return s.replace(z=self.ops.bfd(tmp_q, s.E / s.D, s.E / s.dScale))


@dataclasses.dataclass
class AccState:
    """acc-ADMM state: the iterate and the Halpern machinery
    (``solver_socp_accADMM.m:154-163,369-388``). ``old`` and ``anchor`` are
    iterate tuples in :data:`ITERATE` order; right after ``prep`` and every
    restart they hold the very tensors of ``s``, so no step may update the
    iterate in place."""

    s: SolverState
    old: tuple     # the iterate after the previous averaging
    anchor: tuple  # the Halpern anchor x^0
    k: int         # averaging counter


class AccADMMKernels(Kernels):
    """Halpern-accelerated preconditioned ADMM
    (``solver_socp_accADMM.m:227-249,369-388``). Step order: q, multiplier
    (unit step), phi, z. The KKT battery sees the state before the anchor
    averaging; the averaging of a checked iteration is the driver's
    ``post_check``. Restart every ``restart`` averagings and on a sigma
    change or rescale."""

    RESCALED = ("phi", "q", "z")

    def __init__(self, cfg: LevelConfig, restart: int = 100,
                 rho: float = 2.0):
        super().__init__(cfg)
        self.restart = restart
        self.rho = rho

    def _phi_solve(self, s: SolverState, rhs):
        return self._poisson_solve(s, rhs)

    def _step_parts(self, s: SolverState):
        """The step up to its z-step: (state with phi, q, alpha, beta, the
        phi-step rhs, z2 = BFd q)."""
        ops = self.ops
        sbf = s.E / s.D
        # step q
        q2 = ops.bfd_T(s.z + s.beta, sbf)
        tmp_q = s.D * ops.grad(s.phi)
        q = self._q_solve(s, tmp_q + s.alpha + q2)
        # step alpha, beta (unit step)
        z2 = ops.bfd(q, sbf, s.E / s.dScale)
        alpha = s.alpha + tmp_q - q
        beta = s.beta + s.z - z2
        # step phi
        rhs = s.D * ops.grad_T(q - alpha) + s.c
        phi = self._phi_solve(s, rhs)
        return s.replace(phi=phi, q=q, alpha=alpha, beta=beta), rhs, z2

    def _step(self, s: SolverState) -> SolverState:
        s2, _, z2 = self._step_parts(s)
        return s2.replace(z=proj_soc(z2 - s2.beta))

    def _halpern(self, e: AccState) -> AccState:
        """x <- 1/(k+2) x0 + (k+1)/(k+2) ((1-rho) x_old + rho x), k += 1;
        the anchor restarts when k reaches ``restart``."""
        c1 = 1.0 / (e.k + 2.0)
        c2 = (e.k + 1.0) / (e.k + 2.0)
        rho = self.rho
        new = tuple(c1 * x0 + c2 * ((1.0 - rho) * xo + rho * x)
                    for x0, xo, x in zip(e.anchor, e.old, _iterate(e.s)))
        k1 = e.k + 1
        if k1 >= self.restart:
            return AccState(s=_with_iterate(e.s, new), old=new, anchor=new,
                            k=0)
        return AccState(s=_with_iterate(e.s, new), old=new, anchor=e.anchor,
                        k=k1)

    def segment_impl(self, e: AccState, k: int) -> AccState:
        """k iterations; the last stops before its averaging (a KKT point)."""
        if k < 1:
            return e
        for _ in range(k - 1):
            e = self._halpern(dataclasses.replace(e, s=self._step(e.s)))
        return dataclasses.replace(e, s=self._step(e.s))

    def post_check(self, e: AccState) -> AccState:
        return self._halpern(e)

    def kkt(self, e: AccState) -> dict:
        return super().kkt(e.s)

    def norms(self, e: AccState) -> dict:
        return super().norms(e.s)

    def get_sigma(self, e: AccState) -> float:
        return e.s.sigma

    def sigma_mult(self, e: AccState, factor: float) -> AccState:
        """Scales alpha/beta/c (and the old copies) and restarts the anchor
        at the scaled current iterate (``accADMM.m:346-358``)."""
        inv = 1.0 / factor
        s = super().sigma_mult(e.s, factor)
        old = e.old[:3] + (e.old[3] * inv, e.old[4] * inv)
        return AccState(s=s, old=old, anchor=_iterate(s), k=0)

    def rescale(self, e: AccState, d_scale2: float,
                c_scale2: float) -> AccState:
        return self._acc_state(super().rescale(e.s, d_scale2, c_scale2))

    def prep(self, var: dict, sigma: float) -> AccState:
        return self._acc_state(super().prep(var, sigma))

    @staticmethod
    def _acc_state(s: SolverState) -> AccState:
        """A fresh Halpern state at s: old and anchor are s's iterate."""
        cur = _iterate(s)
        return AccState(s=s, old=cur, anchor=cur, k=0)

    def finalize(self, e: AccState, var: dict) -> dict:
        return super().finalize(e.s, var)


class _SgsPhiStep:
    """The phi-step of the sGS methods: one symmetric red-black sweep
    (``solver_socp_sGSinPALM.m:203-206``) from the current phi, on the
    sweep kernel; plus the sGS block residual the sigma strategy reads,
    the cheap feasibility pair of its 'sGS superior' mode, and the KKT
    battery's sGS-block error.

    A segment leaves in ``last_aux``: ``resi_sgs``, the colour-A residual
    right after the last iteration's sweep (a 0-d tensor), and, when
    ``with_feas`` is set, ``feas_hist``, a (k-1, 2) tensor of
    (primFea1, dualFea1) after each of the first k-1 iterations: the driver
    fetches each in one transfer."""

    def _build_sgs(self):
        # the level's D^2 is passed per sweep
        self.sgs = make_sgs(self.geom, dtype=self.cfg.dtype,
                            device=self.ops.device)
        self.with_feas = False
        self.last_aux = {}

    def _sweep(self, s: SolverState, rhs):
        ops = self.ops
        phi = rb_sweep(self.sgs, ops.phi_from_internal(s.phi),
                       ops.phi_from_internal(rhs), s.D * s.D)
        return ops.phi_to_internal(phi)

    def _resi_sgs(self, s: SolverState, phi, rhs):
        ops = self.ops
        return self.sgs.residual_color_a_norm(
            ops.phi_from_internal(phi), ops.phi_from_internal(rhs),
            self.geom.h, d2=s.D * s.D)

    def _feas_pair(self, s: SolverState) -> torch.Tensor:
        h = self.geom.h
        tmp_q = s.D * self.ops.grad(s.phi)
        prim_fea1 = norm_l2(tmp_q - s.q, h)
        dual_fea1 = s.sigma * norm_l2(s.D * self.ops.grad_T(s.alpha) - s.c, h)
        return torch.stack([prim_fea1, dual_fea1])

    def _set_aux(self, resi_sgs, feas: list) -> None:
        self.last_aux = {"resi_sgs": resi_sgs}
        if feas:
            self.last_aux["feas_hist"] = torch.stack(feas)

    def _kkt(self, s: SolverState) -> dict:
        """KKT battery + the sGS-block error (``sGSinPALM.m:322``,
        ``accsGSADMM.m:358``)."""
        out = super()._kkt(s)
        h = self.geom.h
        resi_alpha = s.D * self.ops.grad(s.phi) - s.q
        t1 = norm_l2(s.D * self.ops.grad_T(resi_alpha), h)
        dual1 = norm_l2(s.D * self.ops.grad_T(s.alpha) - s.c, h)
        out["kkt_sgs_blocks"] = torch.sqrt(t1 * t1 + dual1 * dual1)
        return out

    @staticmethod
    def _demeaned(s: SolverState) -> SolverState:
        """phi minus its mean, once at prep (``sGSinPALM.m:144``,
        ``accsGSADMM.m:165``)."""
        return s.replace(phi=s.phi - torch.mean(s.phi))


class SgsKernels(_SgsPhiStep, Kernels):
    """sGS-based inPALM: the DCT solve replaced by one red-black symmetric
    Gauss-Seidel sweep; the rest of the step is inPALM's."""

    RESCALED = ("phi", "q")

    def __init__(self, cfg: LevelConfig):
        super().__init__(cfg)
        self._build_sgs()

    def _step(self, s: SolverState) -> SolverState:
        return self._step_from_phi(s, self._sweep(s, self._rhs(s)))

    def _step_instrumented(self, s: SolverState):
        """The step, and the sGS block residual right after its sweep
        (``solver_socp_sGSinPALM.m:208-218``)."""
        rhs = self._rhs(s)
        phi = self._sweep(s, rhs)
        return self._step_from_phi(s, phi), self._resi_sgs(s, phi, rhs)

    def segment_impl(self, s: SolverState, k: int) -> SolverState:
        if k < 1:
            return s
        feas = []
        for _ in range(k - 1):
            s = self._step(s)
            if self.with_feas:
                feas.append(self._feas_pair(s))
        s, resi = self._step_instrumented(s)
        self._set_aux(resi, feas)
        return s

    def prep(self, var: dict, sigma: float) -> SolverState:
        return self._demeaned(super().prep(var, sigma))


class AccSgsADMMKernels(_SgsPhiStep, AccADMMKernels):
    """acc-ADMM with the DCT solve replaced by one red-black sGS sweep
    (``solver_socp_accsGSADMM.m:240-274``)."""

    def __init__(self, cfg: LevelConfig, restart: int = 100,
                 rho: float = 2.0):
        super().__init__(cfg, restart=restart, rho=rho)
        self._build_sgs()

    def _phi_solve(self, s: SolverState, rhs):
        return self._sweep(s, rhs)

    def _step_instrumented(self, s: SolverState):
        s2, rhs, z2 = self._step_parts(s)
        resi = self._resi_sgs(s, s2.phi, rhs)
        return s2.replace(z=proj_soc(z2 - s2.beta)), resi

    def segment_impl(self, e: AccState, k: int) -> AccState:
        if k < 1:
            return e
        feas = []
        for _ in range(k - 1):
            e = dataclasses.replace(e, s=self._step(e.s))
            if self.with_feas:
                feas.append(self._feas_pair(e.s))
            e = self._halpern(e)
        s, resi = self._step_instrumented(e.s)
        self._set_aux(resi, feas)
        return dataclasses.replace(e, s=s)

    def prep(self, var: dict, sigma: float) -> AccState:
        e = super().prep(var, sigma)
        return self._acc_state(self._demeaned(e.s))
