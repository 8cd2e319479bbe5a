"""The port's selective scan (``repro_torch.kernels.ref.selective_scan``,
reached through ``ops.selective_scan`` for CPU tensors) against the JAX
package's oracle ``selective_scan_ref``.  The Pallas kernel itself fails
on this JAX version (``pl.load`` is gone), so the oracle is the reference,
as it is for the JAX package's own tests.

Tolerance: rtol = atol = 1e-5.  Both sides scan sequentially in fp32 on
the same inputs; they differ only in the order of the ``h . C`` sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan_ref
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import tensor_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def make_inputs(seed, b, s, di, ds):
    """numpy inputs shaped as the JAX package's test makes them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    u = rng.standard_normal((b, s, di)).astype(f32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, di)))) * 0.1).astype(f32)
    bb = rng.standard_normal((b, s, ds)).astype(f32)
    c = rng.standard_normal((b, s, ds)).astype(f32)
    a_log = np.log(np.abs(rng.standard_normal((di, ds))) + 0.5).astype(f32)
    d = rng.standard_normal(di).astype(f32)
    return u, dt, bb, c, a_log, d


def both(args, u_dtype=np.float32, h0=None):
    """(JAX oracle, port) outputs as numpy, ``u`` in ``u_dtype``."""
    u, *rest = args
    ju = jnp.asarray(u, u_dtype)
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_ref, h_ref = selective_scan_ref(ju, *map(jnp.asarray, rest), h0=jh0)
    tu = tensor_from_numpy(np.asarray(ju), "cpu")
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = ops.selective_scan(tu, *map(torch.from_numpy, rest), th0)
    return (np.asarray(y_ref), np.asarray(h_ref)), (y.numpy(), h.numpy())


@pytest.mark.parametrize("b,s,di,ds", [
    (1, 16, 8, 4), (2, 32, 16, 8), (1, 64, 32, 16), (2, 24, 8, 4)])
def test_plain_scan_matches_jax_oracle(b, s, di, ds):
    (y_ref, h_ref), (y, h) = both(make_inputs(b * 100 + s, b, s, di, ds))
    assert y.dtype == h.dtype == np.float32
    np.testing.assert_allclose(y, y_ref, **TOL)
    np.testing.assert_allclose(h, h_ref, **TOL)


def test_plain_scan_takes_bf16_u():
    """``u`` in bf16 (falcon's compute dtype), widened to fp32 on both
    sides: the same tolerance holds."""
    import ml_dtypes
    args = make_inputs(7, 1, 32, 16, 8)
    (y_ref, h_ref), (y, h) = both(args, u_dtype=ml_dtypes.bfloat16)
    np.testing.assert_allclose(y, y_ref, **TOL)
    np.testing.assert_allclose(h, h_ref, **TOL)


def test_carried_state_two_halves_equal_the_full_run():
    u, dt, b, c, a_log, d = map(torch.from_numpy, make_inputs(3, 2, 64, 8, 4))
    y_full, h_full = ops.selective_scan(u, dt, b, c, a_log, d)
    y1, h1 = ops.selective_scan(u[:, :32], dt[:, :32], b[:, :32], c[:, :32],
                                a_log, d)
    y2, h2 = ops.selective_scan(u[:, 32:], dt[:, 32:], b[:, 32:], c[:, 32:],
                                a_log, d, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h2, h_full, rtol=1e-6, atol=1e-6)


def test_carried_state_matches_jax_oracle():
    args = make_inputs(5, 2, 16, 8, 4)
    h0 = np.random.default_rng(5).standard_normal((2, 8, 4)).astype(
        np.float32)
    (y_ref, h_ref), (y, h) = both(args, h0=h0)
    np.testing.assert_allclose(y, y_ref, **TOL)
    np.testing.assert_allclose(h, h_ref, **TOL)


def test_cpu_tensors_take_the_plain_version():
    args = tuple(map(torch.from_numpy, make_inputs(1, 1, 8, 8, 4)))
    before = ops.launch_counts()["selective_scan"]
    y, h = ops.selective_scan(*args)
    want_y, want_h = ref.selective_scan(*args)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert ops.launch_counts()["selective_scan"] == before
