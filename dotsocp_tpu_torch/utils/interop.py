"""Build the port's level variables and solver state from numpy arrays laid
out as the JAX package lays them out, and back.

The tests start both packages from the same state (a lockstep fleet's
too: :func:`batch_state_from_numpy` stacks per-instance states): they take
``LevelVar.as_dict()`` or the ``SolverState`` / ``AccState`` /
``NesterovState`` fields of
``dotsocp_tpu`` as numpy arrays (``jax.device_get``), hand them to these
functions, and compare the results field by field. Staggered fields arrive
as ``(q0, bs)`` pairs with ``bs`` a sequence of per-axis blocks; the flat
solver state's face blocks, all ``(nt, S)``, become one ``(d, nt, S)``
tensor here. A state in the JAX package's shaped layout (``"3d"``, where
its sGS kernels run) is converted to the port's flat layout on the way,
and, for a rank of a mesh, cut to that rank's block of the halo layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..algorithms.core import SolverState
from ..algorithms.variants import ITERATE, AccState, NesterovState
from ..multilevel.level import LevelVar
from ..ops.engine import OpsFlat
from ..ops.geometry import Geometry
from ..ops.staggered import Staggered

STATE_ARRAYS = ("phi", "z", "beta", "c")
STATE_FIELDS = ("q", "alpha")
STATE_SCALARS = ("sigma", "cScale", "dScale", "norm_c", "norm_d",
                 "sigmaScale", "D", "E")


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.array(a), dtype=dtype, device=device)


def _staggered(st, device, dtype, stack: bool) -> Staggered:
    q0, bs = st
    blocks = tuple(_tensor(b, device, dtype) for b in bs)
    return Staggered(_tensor(q0, device, dtype),
                     torch.stack(blocks) if stack else blocks)


def level_var_from_numpy(var: dict, rho0, rho1, *, device,
                         dtype: torch.dtype, weight=None) -> LevelVar:
    """A port ``LevelVar`` (shaped layout) from a JAX ``LevelVar.as_dict()``
    whose arrays are numpy, plus the level's densities and, for a weighted
    level, its weight (see :func:`weight_from_numpy`)."""
    phi = _tensor(var["phi"], device, dtype)
    geom = Geometry(nt=phi.shape[0], space=tuple(phi.shape[1:]))
    return LevelVar(
        geom=geom,
        rho0=_tensor(rho0, device, dtype),
        rho1=_tensor(rho1, device, dtype),
        c=_tensor(var["c"], device, dtype),
        phi=phi,
        q=_staggered(var["q"], device, dtype, stack=False),
        z=_tensor(var["z"], device, dtype),
        alpha=_staggered(var["alpha"], device, dtype, stack=False),
        beta=_tensor(var["beta"], device, dtype),
        weight=(None if weight is None else
                weight_from_numpy(weight, device=device, dtype=dtype)),
        D=float(var["D"]), E=float(var["E"]),
        cScale=float(var["cScale"]), dScale=float(var["dScale"]),
        norm_c=float(var["norm_c"]), norm_d=float(var["norm_d"]),
    )


def weight_from_numpy(weight, *, device, dtype: torch.dtype) -> Staggered:
    """The port's shaped weight from a JAX ``Staggered`` weight of numpy
    arrays (``jax.device_get`` of ``models.wdot2d.get_weight_by_barrier``),
    or a ``(q0, bs)`` pair."""
    q0, bs = weight
    return _staggered((q0, bs), device, dtype, stack=False)


class _Layout:
    """Converts the iterate fields of a JAX solver state, flat or shaped,
    to the port's flat tensors."""

    def __init__(self, fields: dict, device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        phi = np.shape(fields["phi"])
        self.ops = None
        # flat face blocks are phi-shaped (ghost slot); shaped ones are not
        if np.shape(fields["q"][1][0]) != phi:
            geom = Geometry(nt=phi[0], space=tuple(phi[1:]))
            self.ops = OpsFlat(geom, dtype, device)

    def __call__(self, name: str, value):
        dev, dt, ops = self.device, self.dtype, self.ops
        if name in STATE_FIELDS:
            st = _staggered(value, dev, dt, stack=ops is None)
            return st if ops is None else ops.stag_to_internal(st)
        t = _tensor(value, dev, dt)
        if ops is None:
            return t
        if name in ("phi", "c"):
            return ops.phi_to_internal(t).contiguous()
        return ops.z_to_internal(t).contiguous()


def state_from_numpy(fields: dict, *, device, dtype: torch.dtype,
                     mesh=None) -> SolverState:
    """A port ``SolverState`` (flat layout) from the fields of a JAX
    ``SolverState``, flat or shaped layout (``state._asdict()`` after
    ``jax.device_get``); with ``mesh``, this rank's block of it
    (``parallel/sharding.shard_state``)."""
    conv = _Layout(fields, device, dtype)
    kw = {k: conv(k, fields[k]) for k in STATE_ARRAYS + STATE_FIELDS}
    kw.update({k: float(fields[k]) for k in STATE_SCALARS})
    state = SolverState(**kw)
    if mesh is None:
        return state
    if conv.ops is None:
        raise ValueError("a state for a rank of a mesh arrives shaped (the "
                         "JAX '3d' layout): flat fields do not carry the "
                         "grid")
    from ..parallel.sharding import shard_state

    return shard_state(state, mesh, conv.ops.geom)


def acc_state_from_numpy(fields: dict, *, device,
                         dtype: torch.dtype) -> AccState:
    """A port ``AccState`` from the fields of a JAX ``AccState``
    (``e._asdict()`` after ``jax.device_get``: ``s`` a ``SolverState``,
    ``old`` and ``anchor`` iterate tuples, ``k`` the averaging counter)."""
    s = fields["s"]._asdict()
    conv = _Layout(s, device, dtype)
    return AccState(
        s=state_from_numpy(s, device=device, dtype=dtype),
        old=tuple(conv(n, v) for n, v in zip(ITERATE, fields["old"])),
        anchor=tuple(conv(n, v) for n, v in zip(ITERATE, fields["anchor"])),
        k=int(fields["k"]),
    )


def nesterov_state_from_numpy(fields: dict, *, device,
                              dtype: torch.dtype) -> NesterovState:
    """A port ``NesterovState`` from the fields of a JAX ``NesterovState``
    (``s``, the iterate tuples ``old`` and ``hat_old``, the counter ``k``)."""
    s = fields["s"]._asdict()
    conv = _Layout(s, device, dtype)
    return NesterovState(
        s=state_from_numpy(s, device=device, dtype=dtype),
        old=tuple(conv(n, v) for n, v in zip(ITERATE, fields["old"])),
        hat_old=tuple(conv(n, v) for n, v in zip(ITERATE, fields["hat_old"])),
        k=int(fields["k"]),
    )


def state_to_numpy(state: SolverState) -> dict:
    """The inverse of :func:`state_from_numpy`: numpy arrays with the face
    blocks as a tuple, scalars as floats."""
    out = {k: getattr(state, k).cpu().numpy() for k in STATE_ARRAYS}
    for k in STATE_FIELDS:
        st = getattr(state, k)
        out[k] = (st.q0.cpu().numpy(), tuple(b.cpu().numpy() for b in st.bs))
    out.update({k: float(getattr(state, k)) for k in STATE_SCALARS})
    return out


def batch_state_from_numpy(fields_list, *, device,
                           dtype: torch.dtype) -> SolverState:
    """The port's batched state (the lockstep fleet's,
    ``parallel/batch.py``) from the fields of B per-instance JAX
    ``SolverState``s as numpy (``state._asdict()`` after
    ``jax.device_get``; one level, so one D and one E)."""
    from ..parallel.batch import stack_states

    return stack_states([state_from_numpy(f, device=device, dtype=dtype)
                         for f in fields_list])


def batch_state_to_numpy(state: SolverState) -> list:
    """The inverse of :func:`batch_state_from_numpy`: one
    :func:`state_to_numpy` dict per instance."""
    from ..algorithms.core import instance

    return [state_to_numpy(instance(state, b))
            for b in range(state.phi.shape[0])]
