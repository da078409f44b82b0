"""The legacy parabolic projection (``ProjParab.m``) of the PyTorch port,
``ops/parabola.proj_parab``, against the JAX function in float64 on the
CPU at 1e-12, and its own properties: idempotent, the input's dtype kept,
and the root it takes the largest real root of the cubic
(numpy's companion-matrix roots)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.ops.parabola import proj_parab as jproj_parab

from dotsocp_tpu_torch.ops.parabola import proj_parab


@pytest.mark.parametrize("k", [1, 2, 4])
def test_proj_parab_matches_jax_f64(rng, k):
    # both root branches: large |b| and a < 0 rows take Cardano, others the
    # trigonometric form
    q = rng.standard_normal((500, 1 + k)) * np.array([4.0] + [3.0] * k)
    got = proj_parab(torch.from_numpy(q)).numpy()
    want = np.asarray(jproj_parab(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_proj_parab_largest_root_and_idempotent(rng):
    q = rng.standard_normal((100, 5)) * 2
    out = proj_parab(torch.from_numpy(q)).numpy()
    for i in range(0, 100, 7):
        a = q[i, 0]
        nb = np.linalg.norm(q[i, 1:])
        roots = np.roots([1, 8 - a, 16 - 8 * a, -16 * a - 2 * nb])
        lam = max(roots[np.abs(roots.imag) < 1e-9].real.max(), 0.0)
        ref = np.concatenate([[a - lam], q[i, 1:] / (1 + lam)])
        np.testing.assert_allclose(out[i], ref, atol=1e-8)
    again = proj_parab(torch.from_numpy(out)).numpy()
    np.testing.assert_allclose(again, out, atol=1e-10)


def test_proj_parab_keeps_dtype(rng):
    q = torch.from_numpy(rng.standard_normal((20, 3))).float()
    out = proj_parab(q)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(),
                               proj_parab(q.double()).float().numpy())
