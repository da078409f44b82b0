"""Algorithm variants: PALM, acc-ADMM (Halpern, and its Nesterov branch
for theta != 2), sGS-inPALM, acc-sGS-ADMM; port of
``dotsocp_tpu/algorithms/variants.py``.

Each variant supplies its step order and which iterate blocks a dynamic
rescale divides (``Kernels.RESCALED``: exactly the blocks the reference
scales, i.e. those consumed before being recomputed):

- inPALM (base :class:`~.core.Kernels`): q, z (``solver_socp_inPALM.m:174-178``)
- PALM: phi, z; phi stands in for the reference's ``tmp_q = A*phi`` cache
  (``solver_socp_PALM.m``)
- sGS-inPALM: phi, q (``solver_socp_sGSinPALM.m:185-190``)
- acc-ADMM and acc-sGS-ADMM: phi, q, z, and the Halpern anchors restart
  (``solver_socp_accADMM.m:204-224``)

acc-ADMM also takes a weight (the obstacle problems; ``WDOT_METHODS``):
its q-step and multipliers use w as inPALM's do
(``dotsocp_tpu/algorithms/variants.py:127-150``).

These variants run their own step in a plain loop (``Kernels.segment_impl``);
the sGS methods' phi-step is one red-black sweep, the CUDA kernel of
``ops/sgs_sweep.py`` on the card. sGS-inPALM's step after its sweep is
inPALM's single step (``Kernels._step_from_phi``: the z_step, q_step and
beta_step kernels), every acc step closes with the cone projection
kernel ``cone_project_diff``, and every step forms its phi-step
right-hand side with the rhs kernel (``fused_step.phi_rhs``; plain on the
halo engine). The rest of each step is plain PyTorch, as
the JAX package runs it in jnp: acc-ADMM's q- and beta-steps form beta as
(beta + z) - z2, not beta_step's beta + tau (z - z2), and PALM's steps wait
for their own kernels (ROADMAP.md). On one process the tensors are in the
flat layout (``ops/engine.py``): the JAX package moves the sGS kernels to
its shaped engine only because its TPU sweep wanted a shaped array, and
the flat phi is that array reshaped. Under a mesh they are one rank's
block of the halo layout, the sweep is ``ops/halo_engine.HaloSGS`` and
the steps that read neighbouring cells run their plain versions
(``fused_step.on_kernel``), as the JAX package under a mesh
(``dotsocp_tpu/algorithms/variants.py:347-356,485-492``); the cone
projection kernel runs on the rank's block, whose pads it keeps at zero.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.cone import proj_soc
from ..ops.fused_step import cone_project_diff, phi_rhs
from ..ops.halo_engine import HaloSGS
from ..ops.sgs import make_sgs
from ..ops.sgs_sweep import rb_sweep
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
        # step q0: uses A*phi from the previous iteration
        tmp_q = s.D * ops.grad(s.phi)
        q2 = self._bfd_T(s, s.z + s.beta)
        q = self._q_solve(s, tmp_q, q2)
        # step phi
        phi = self._poisson_solve(s, phi_rhs(ops, q, s.alpha, s.c, s.D))
        # step z (z2 refreshed from the q0-step's q)
        z = proj_soc(self._bfd(s, q) - s.beta, ops.cone_dim)
        # step q (second)
        tmp_q = s.D * ops.grad(phi)
        q2 = self._bfd_T(s, z + s.beta)
        q = self._q_solve(s, tmp_q, q2)
        # multipliers
        z2 = self._bfd(s, q)
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
    # the q-step is ``_q_solve``, plain PyTorch
    weighted_q_kernels = False

    def __init__(self, cfg: LevelConfig, weight=None, restart: int = 100,
                 rho: float = 2.0):
        super().__init__(cfg, weight)
        self.restart = restart
        self.rho = rho

    def _phi_solve(self, s: SolverState, rhs):
        return self._poisson_solve(s, rhs)

    def _step_parts(self, s: SolverState):
        """The step up to its z-step: (state with phi, q, alpha, beta, the
        phi-step rhs, z2 = BFd q)."""
        ops = self.ops
        # step q
        q2 = self._bfd_T(s, s.z + s.beta)
        tmp_q = s.D * ops.grad(s.phi)
        q = self._q_solve(s, tmp_q, q2)
        # step alpha, beta (unit step); weighted with w q
        # (``dotsocp_tpu/algorithms/variants.py:133-150``)
        z2 = self._bfd(s, q)
        alpha = s.alpha + tmp_q - self._w(q)
        beta = s.beta + s.z - z2
        # step phi
        rhs = phi_rhs(ops, q, alpha, s.c, s.D, self.weight)
        phi = self._phi_solve(s, rhs)
        return s.replace(phi=phi, q=q, alpha=alpha, beta=beta), rhs, z2

    def _step(self, s: SolverState) -> SolverState:
        s2, _, z2 = self._step_parts(s)
        return s2.replace(z=cone_project_diff(z2, s2.beta))

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
            e = self.post_check(dataclasses.replace(e, s=self._step(e.s)))
        return dataclasses.replace(e, s=self._step(e.s))

    def post_check(self, e: AccState) -> AccState:
        """The averaging after a step: Halpern's (the Nesterov branch
        extrapolates instead)."""
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


@dataclasses.dataclass
class NesterovState:
    """State of acc-ADMM's Nesterov branch, theta != 2
    (``solver_socp_accADMM.m:389-421``): iterate tuples in :data:`ITERATE`
    order. Right after ``prep`` and every rescale ``old`` and ``hat_old``
    hold the very tensors of ``s``; ``hat_old`` is read only when k > 0."""

    s: SolverState
    old: tuple      # x_old
    hat_old: tuple  # xHat_old
    k: int          # extrapolation counter


class AccADMMNesterovKernels(AccADMMKernels):
    """acc-ADMM with Nesterov-type extrapolation instead of Halpern
    anchoring: the reference's ``theta != 2`` branch
    (``dotsocp_tpu/algorithms/variants.py:243-335``). The step is acc-ADMM's;
    host driver only, as in the JAX package."""

    def __init__(self, cfg: LevelConfig, weight=None, restart: int = 100,
                 rho: float = 2.0, theta: float = 3.0):
        super().__init__(cfg, weight, restart=restart, rho=rho)
        self.theta = theta

    def _extrapolate(self, e: NesterovState) -> NesterovState:
        """xHat = (1-rho) x_old + rho x; x <- (1-c1) x_old + c1 xHat at
        k = 0, else (1-c1) x_old + (c1+c2) xHat - c2 xHat_old, with
        c1 = theta / (2 (k + theta)), c2 = k / (k + theta); k += 1, back to
        0 (keeping xHat_old) when it reaches ``restart``."""
        rho, theta, k = self.rho, self.theta, e.k
        c1 = theta / (2.0 * (k + theta))
        c2 = k / (k + theta)
        hat = tuple((1.0 - rho) * xo + rho * x
                    for xo, x in zip(e.old, _iterate(e.s)))
        if k == 0:
            new = tuple((1.0 - c1) * xo + c1 * xh
                        for xo, xh in zip(e.old, hat))
        else:
            new = tuple((1.0 - c1) * xo + (c1 + c2) * xh - c2 * xho
                        for xo, xh, xho in zip(e.old, hat, e.hat_old))
        s = _with_iterate(e.s, new)
        if k + 1 >= self.restart:
            return NesterovState(s=s, old=new, hat_old=e.hat_old, k=0)
        return NesterovState(s=s, old=new, hat_old=hat, k=k + 1)

    def post_check(self, e: NesterovState) -> NesterovState:
        return self._extrapolate(e)

    def sigma_mult(self, e: NesterovState, factor: float) -> NesterovState:
        """Scales alpha/beta/c and the old copies; the counter restarts."""
        inv = 1.0 / factor
        s = Kernels.sigma_mult(self, e.s, factor)
        old = e.old[:3] + (e.old[3] * inv, e.old[4] * inv)
        return NesterovState(s=s, old=old, hat_old=e.hat_old, k=0)

    def rescale(self, e: NesterovState, d_scale2: float,
                c_scale2: float) -> NesterovState:
        return self._nesterov_state(
            Kernels.rescale(self, e.s, d_scale2, c_scale2))

    def prep(self, var: dict, sigma: float) -> NesterovState:
        return self._nesterov_state(Kernels.prep(self, var, sigma))

    @staticmethod
    def _nesterov_state(s: SolverState) -> NesterovState:
        cur = _iterate(s)
        return NesterovState(s=s, old=cur, hat_old=cur, k=0)


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

    # the phi-step is the sweep: no DCT solve, on any route
    fast_dct = False
    dct_kernel = False

    def _build_sgs(self):
        # the level's D^2 is passed per sweep; under a mesh the halo sweep
        # (``dotsocp_tpu/algorithms/variants.py:347-356,485-492``)
        self.halo_sgs = self.ops.mesh is not None
        if self.halo_sgs:
            self.sgs = HaloSGS(self.ops)
        else:
            self.sgs = make_sgs(self.geom, dtype=self.cfg.dtype,
                                device=self.ops.device)
        self.with_feas = False
        self.last_aux = {}

    def _sweep(self, s: SolverState, rhs):
        """One sweep: the halo sweep under a mesh, else the sweep kernel on
        the shaped phi (the flat phi reshaped)."""
        if self.halo_sgs:
            return self.sgs.sweep(s.phi, rhs, d2=s.D * s.D)
        ops = self.ops
        phi = rb_sweep(self.sgs, ops.phi_from_internal(s.phi),
                       ops.phi_from_internal(rhs), s.D * s.D)
        return ops.phi_to_internal(phi)

    def _resi_sgs(self, s: SolverState, phi, rhs):
        ops = self.ops
        if not self.halo_sgs:
            phi, rhs = ops.phi_from_internal(phi), ops.phi_from_internal(rhs)
        return self.sgs.residual_color_a_norm(phi, rhs, self.geom.h,
                                              d2=s.D * s.D)

    def _feas_pair(self, s: SolverState) -> torch.Tensor:
        tmp_q = s.D * self.ops.grad(s.phi)
        prim_fea1, dual1 = self._norms_of(
            tmp_q - s.q, s.D * self.ops.grad_T(s.alpha) - s.c)
        return torch.stack([prim_fea1, s.sigma * dual1])

    def _set_aux(self, resi_sgs, feas: list) -> None:
        self.last_aux = {"resi_sgs": resi_sgs}
        if feas:
            self.last_aux["feas_hist"] = torch.stack(feas)

    def _kkt(self, s: SolverState) -> dict:
        """KKT battery + the sGS-block error (``sGSinPALM.m:322``,
        ``accsGSADMM.m:358``)."""
        out = super()._kkt(s)
        resi_alpha = s.D * self.ops.grad(s.phi) - s.q
        t1, dual1 = self._norms_of(s.D * self.ops.grad_T(resi_alpha),
                                   s.D * self.ops.grad_T(s.alpha) - s.c)
        out["kkt_sgs_blocks"] = torch.sqrt(t1 * t1 + dual1 * dual1)
        return out

    def _demeaned(self, s: SolverState) -> SolverState:
        """phi minus its mean, once at prep (``sGSinPALM.m:144``,
        ``accsGSADMM.m:165``)."""
        return s.replace(phi=self.ops.demean(s.phi))


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
        return (self._step_from_phi(s, phi),
                self._resi_sgs(s, phi, rhs))

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
        return s2.replace(z=cone_project_diff(z2, s2.beta)), resi

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
