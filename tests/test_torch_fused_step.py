"""The x-carry step kernels of the PyTorch port (``ops/fused_step.py``).

On the CPU each wrapper runs its plain PyTorch version. Here those plain
versions, in float32, are held against the JAX package's Pallas kernels of
``make_fused_flat_step`` run in interpret mode, on the same seeded inputs,
at 17^2 x 7 (2D) and 33 x 7 (1D). Tolerance rtol 2e-5, atol 2e-6, as
``tests/test_pallas.py`` holds the Pallas kernels against the jnp ops: the
two sides differ by FMA contraction, the association of the four-term face
sum in BF^T, and the q-step diagonal (one float per slab here, an f32 array
there), each a few ulp.

The CA segment (x prologue, qx + cx iterations, cx_final) is held against
the JAX ``run_segment`` with the Pallas kernels, and, in float64, against
the port's own plain steps. The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` compares them with these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
from dotsocp_tpu.algorithms.variants import InPALMKernels
from dotsocp_tpu.models import examples as jexamples
from dotsocp_tpu.multilevel.level import initial_scaling as j_initial_scaling
from dotsocp_tpu.multilevel.level import initialize as j_initialize
from dotsocp_tpu.ops.engine import OpsFlat as JOpsFlat
from dotsocp_tpu.ops.geometry import Geometry as JGeometry
from dotsocp_tpu.ops.pallas_kernels import make_fused_flat_step
from dotsocp_tpu.ops.staggered import Staggered as JStaggered

from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops.engine import OpsFlat, diag_values
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered
from dotsocp_tpu_torch.utils.interop import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 2e-6
F32 = torch.float32
GEOMS = {"2d": (7, (17, 17)), "1d": (7, (33,))}
# level scalars of a real level (example2 17^2 x 7 after InitialScaling)
D, E, DSCALE, TAU = 0.2690, 0.1902, 0.2690, 1.9


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(a, dtype=F32):
    return torch.tensor(np.array(a), dtype=dtype)


class Inputs:
    """Seeded f32 inputs of one geometry, in both packages' flat layouts;
    face blocks keep exactly-zero ghost slots, as the solver does."""

    def __init__(self, name, seed=0):
        nt, space = GEOMS[name]
        self.geom = Geometry(nt=nt, space=space)
        jgeom = JGeometry(nt=nt, space=space)
        g = self.geom
        self.jops = JOpsFlat(jgeom, jnp.float32)
        self.tops = OpsFlat(g, F32, "cpu")
        self.kern = make_fused_flat_step(jgeom, self.jops.strides,
                                         self.jops.masks, TAU, jnp.float32,
                                         interpret=True)
        rng = np.random.default_rng(seed)
        S = self.tops.S
        cone = (g.cone_cols, g.nt - 1, S)

        def stag():
            st = JStaggered(
                q0=rng.standard_normal(g.q0_shape).astype(np.float32),
                bs=tuple(rng.standard_normal(g.b_shape(a)).astype(np.float32)
                         for a in range(g.ndim_space)))
            flat = self.jops.stag_to_internal(st)
            return (JStaggered(jnp.asarray(flat.q0),
                               tuple(jnp.asarray(b) for b in flat.bs)),
                    Staggered(_t(flat.q0), torch.stack([_t(b) for b in flat.bs])))

        self.jq, self.tq = stag()
        self.ja, self.ta = stag()
        self.phi = rng.standard_normal((g.nt, S)).astype(np.float32)
        self.beta = rng.standard_normal(cone).astype(np.float32)
        self.x = rng.standard_normal(cone).astype(np.float32)
        self.sbf, self.sd = E / D, E / DSCALE
        diag = self.jops.oper_q_diag(D, E, None)
        self.jdinv = jax.tree.map(lambda v: 1.0 / v, diag)
        d_in, d_bd = diag_values(D, E)
        self.tdinv = (1.0 / d_in, 1.0 / d_bd)


@pytest.fixture(params=list(GEOMS))
def inp(request):
    return Inputs(request.param)


def test_x_step_matches_pallas(inp):
    want = inp.kern["x_step"](inp.jq.q0, list(inp.jq.bs),
                              jnp.asarray(inp.beta), inp.sbf, inp.sd)
    before = dict(fs.LAUNCHES)
    got = fs.x_step(inp.tops, inp.tq, _t(inp.beta), inp.sbf, inp.sd)
    close(got, want)
    assert fs.LAUNCHES == before  # CPU tensors take the plain version


def test_qx_step_matches_pallas(inp):
    q0n, bns, a0n, abns = inp.kern["qx_step"](
        jnp.asarray(inp.phi), jnp.asarray(inp.x), inp.ja.q0, list(inp.ja.bs),
        inp.jdinv.q0, list(inp.jdinv.bs), jnp.float32(D),
        jnp.float32(inp.sbf), jnp.float32(TAU))
    q, alpha = fs.qx_step(inp.tops, _t(inp.phi), _t(inp.x), inp.ta,
                          inp.tdinv, D, inp.sbf, TAU)
    close(q.q0, q0n)
    close(alpha.q0, a0n)
    for a in range(inp.geom.ndim_space):
        close(q.bs[a], bns[a])
        close(alpha.bs[a], abns[a])
        # the ghost slots of the face outputs stay exactly zero
        ghost = q.bs[a] * (1.0 - inp.tops.masks[a])
        assert torch.all(ghost == 0.0)


@pytest.mark.parametrize("final", [False, True], ids=["cx_step", "cx_final"])
def test_cx_matches_pallas(inp, final):
    name = "cx_final" if final else "cx_step"
    want_beta, want_x = inp.kern[name](
        jnp.asarray(inp.beta), jnp.asarray(inp.x), inp.jq.q0,
        list(inp.jq.bs), jnp.float32(inp.sbf), jnp.float32(inp.sd),
        jnp.float32(TAU))
    fn = fs.cx_final if final else fs.cx_step
    beta, x = fn(inp.tops, _t(inp.beta), _t(inp.x), inp.tq, inp.sbf,
                 inp.sd, TAU)
    close(beta, want_beta)
    close(x, want_x)


# -- the CA segment ------------------------------------------------------------

def _jax_level(dtype):
    r0, r1 = jexamples.get_example_2d("example2", 17, 17)
    lv = j_initialize(r0, r1, 7, dtype=dtype)
    j_initial_scaling(lv, scaling=True)
    return lv


def _jax_kernels(lv, dtype, use_pallas):
    cfg = JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=TAU, dtype=dtype,
                       layout="flat", use_pallas=use_pallas)
    return InPALMKernels(cfg)


def _port_kernels(lv, dtype):
    cfg = LevelConfig(geom=Geometry(lv.geom.nt, lv.geom.space), D=lv.D,
                      E=lv.E, tau=TAU, dtype=dtype, device="cpu")
    return Kernels(cfg)


def _fields(state):
    return jax.device_get(state._asdict())


def _assert_state_close(got: dict, want: dict, rtol, atol):
    for k in ("phi", "z", "beta", "c"):
        close(got[k], want[k], rtol, atol)
    for k in ("q", "alpha"):
        close(got[k][0], want[k][0], rtol, atol)
        for a, b in zip(got[k][1], want[k][1]):
            close(a, b, rtol, atol)


@pytest.mark.parametrize("k", [1, 4])
def test_ca_segment_matches_jax_pallas_segment(k):
    """The port's segment (plain versions on the CPU) against the JAX
    segment through its Pallas kernels, from the same f32 state."""
    lv = _jax_level(jnp.float32)
    jk = _jax_kernels(lv, jnp.float32, use_pallas=True)
    assert jk.segment_ca
    s0 = jk.prep(lv.as_dict(), sigma=1.0)
    start = _fields(s0)
    want = _fields(jk.run_segment(s0, k))
    tk = _port_kernels(lv, F32)
    got = state_to_numpy(tk.run_segment(
        state_from_numpy(start, device="cpu", dtype=F32), k))
    _assert_state_close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("k", [1, 4])
def test_ca_segment_matches_plain_steps_f64(k):
    """In float64 the CA structure (x carried in the z slot) leaves the
    same boundary state as k plain steps, to rounding."""
    lv = _jax_level(jnp.float64)
    tk = _port_kernels(lv, torch.float64)
    s = state_from_numpy(_fields(_jax_kernels(lv, jnp.float64, False).prep(
        lv.as_dict(), sigma=1.0)), device="cpu", dtype=torch.float64)
    plain = s.clone()
    for _ in range(k):
        plain = tk._step_plain(plain)
    seg = tk.run_segment(s.clone(), k)
    _assert_state_close(state_to_numpy(seg), state_to_numpy(plain), 1e-12,
                        1e-12)


def test_plain_steps_match_jax_steps_f64():
    """The port's plain inPALM step against the JAX jnp step in float64."""
    lv = _jax_level(jnp.float64)
    jk = _jax_kernels(lv, jnp.float64, use_pallas=False)
    tk = _port_kernels(lv, torch.float64)
    js = jk.prep(lv.as_dict(), sigma=1.0)
    ts = state_from_numpy(_fields(js), device="cpu", dtype=torch.float64)
    for _ in range(3):
        js = jk.run_one(js)
        ts = tk._step_plain(ts)
    _assert_state_close(state_to_numpy(ts), _fields(js), 1e-12, 1e-13)


def test_segment_zero_steps_is_identity():
    lv = _jax_level(jnp.float64)
    tk = _port_kernels(lv, torch.float64)
    s = state_from_numpy(_fields(_jax_kernels(lv, jnp.float64, False).prep(
        lv.as_dict(), sigma=1.0)), device="cpu", dtype=torch.float64)
    assert tk.run_segment(s, 0) is s


# -- dispatch ------------------------------------------------------------------

def test_wrappers_refuse_other_devices():
    g = Geometry(nt=5, space=(9,))
    ops = OpsFlat(g, F32, "cpu")
    q = Staggered(torch.zeros(4, 9, device="meta"),
                  torch.zeros(1, 5, 9, device="meta"))
    beta = torch.zeros(6, 4, 9, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fs.x_step(ops, q, beta, 1.0, 1.0)
    with pytest.raises(ValueError, match="several devices"):
        fs.x_step(ops, Staggered(torch.zeros(4, 9), torch.zeros(1, 5, 9)),
                  beta, 1.0, 1.0)


def test_launch_counter_reset():
    fs.LAUNCHES["x_step"] += 3
    fs.reset_launches()
    assert set(fs.LAUNCHES.values()) == {0}
    assert set(fs.LAUNCHES) == {"x_step", "qx_step", "qx_step_w", "cx_step",
                                "cx_final", "z_step", "q_step", "q_step_w",
                                "beta_step", "cone_project_diff", "x_step_b",
                                "qx_step_b", "cx_step_b", "cx_final_b",
                                "phi_rhs", "phi_rhs_w", "kkt_sums",
                                "kkt_sums_w"}
