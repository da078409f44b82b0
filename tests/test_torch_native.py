"""The port's copy of the native golden kernels (``dotsocp_tpu_torch/native``)
against the JAX package's (``dotsocp_tpu/native``), and the port's shaped
operators and sGS smoother against them, in float64 on the CPU.

- Each wrapper (``proj_soc``, ``bfd2d``, ``bfd_conj2d``, ``rb_sgs``) is
  bit-equal to the JAX module's on the same arrays: one source, built with
  the same flags.
- The port's ``proj_soc``, shaped ``bfd`` and ``bfd_T`` (``ops/cone.py``,
  through ``ops/engine.Ops3D``) and its plain red-black sweep
  (``ops/sgs.py``) against the native kernels, as ``tests/test_native.py``
  holds the JAX operators: 1e-14, 1e-14, 1e-13 and 1e-12 (D = 0.83, two
  sweeps).
- The library lands under ``build/native/``; a wrapper refuses what is not
  a CPU float64 tensor of the expected shape.
"""
import os

import numpy as np
import pytest
import torch

import dotsocp_tpu.native as jnative
from dotsocp_tpu_torch import native
from dotsocp_tpu_torch.ops.cone import proj_soc
from dotsocp_tpu_torch.ops.engine import Ops3D
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.sgs import make_sgs
from dotsocp_tpu_torch.ops.staggered import Staggered

F64 = torch.float64
NT, NY, NX = 6, 7, 9


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return {
        "z": rng.standard_normal((10, 40)),
        "q0": rng.standard_normal((NT - 1, NY, NX)),
        "by": rng.standard_normal((NT, NY - 1, NX)),
        "bx": rng.standard_normal((NT, NY, NX - 1)),
        "x": rng.standard_normal((10, NT - 1, NY, NX)),
        "phi": rng.standard_normal((NT, NY, NX)),
        "rhs": rng.standard_normal((NT, NY, NX)),
    }


def _t(a) -> torch.Tensor:
    return torch.tensor(a, dtype=F64)


def _ours(name, a):
    """The port's wrapper ``name`` and the JAX module's on the same arrays,
    as numpy."""
    if name == "proj_soc":
        return [native.proj_soc(_t(a["z"]))], [jnative.proj_soc(a["z"])]
    if name == "bfd2d":
        args = (NT, NY, NX, 0.63, 1.7)
        return ([native.bfd2d(_t(a["q0"]), _t(a["by"]), _t(a["bx"]), *args)],
                [jnative.bfd2d(a["q0"], a["by"], a["bx"], *args)])
    if name == "bfd_conj2d":
        return (list(native.bfd_conj2d(_t(a["x"]), NT, NY, NX, 0.63)),
                list(jnative.bfd_conj2d(a["x"], NT, NY, NX, 0.63)))
    return ([native.rb_sgs(_t(a["phi"]), _t(a["rhs"]), 0.83 ** 2, its=2)],
            [jnative.rb_sgs(a["phi"], a["rhs"], scale=0.83 ** 2, its=2)])


@pytest.mark.parametrize("name", ["proj_soc", "bfd2d", "bfd_conj2d",
                                  "rb_sgs"])
def test_wrapper_bit_equal_to_jax_native(arrays, name):
    got, want = _ours(name, arrays)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == F64 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)


def test_native_proj_soc(arrays):
    z = _t(arrays["z"])
    np.testing.assert_allclose(proj_soc(z).numpy(), native.proj_soc(z).numpy(),
                               atol=1e-14)


def test_native_bfd(arrays):
    ops = Ops3D(Geometry(NT, (NY, NX)), F64, "cpu")
    q = Staggered(_t(arrays["q0"]), (_t(arrays["by"]), _t(arrays["bx"])))
    gold = native.bfd2d(q.q0, *q.bs, NT, NY, NX, 0.63, 1.7)
    np.testing.assert_allclose(ops.bfd(q, 0.63, 1.7).numpy(), gold.numpy(),
                               atol=1e-14)


def test_native_bfd_conj(arrays):
    ops = Ops3D(Geometry(NT, (NY, NX)), F64, "cpu")
    x = _t(arrays["x"])
    ours = ops.bfd_T(x, 0.63)
    for a, b in zip(ours.blocks(), native.bfd_conj2d(x, NT, NY, NX, 0.63)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-13)


def test_native_sgs(arrays):
    D = 0.83
    sgs = make_sgs(Geometry(NT, (NY, NX)), dtype=F64)
    phi, rhs = _t(arrays["phi"]), _t(arrays["rhs"])
    ours = sgs.sweep(phi, rhs, its=2, d2=D * D)
    gold = native.rb_sgs(phi, rhs, scale=D * D, its=2)
    np.testing.assert_allclose(ours.numpy(), gold.numpy(), atol=1e-12)
    # the input is left as it was
    np.testing.assert_array_equal(phi.numpy(), arrays["phi"])


def test_library_builds_under_build_native():
    path = native.build()
    assert os.path.isfile(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == os.path.join(root, "build", "native")


def test_wrappers_refuse_other_tensors(arrays):
    with pytest.raises(TypeError, match="CPU float64"):
        native.proj_soc(torch.tensor(arrays["z"], dtype=torch.float32))
    with pytest.raises(TypeError, match="CPU float64"):
        native.proj_soc(arrays["z"])
    with pytest.raises(ValueError, match="shape"):
        native.bfd_conj2d(_t(arrays["x"]), NT, NY + 1, NX, 0.63)
    with pytest.raises(ValueError, match="shape"):
        native.rb_sgs(_t(arrays["z"]), _t(arrays["z"]), 1.0)
