"""The selective scan's gradient on the CPU (the training path, ROADMAP
A14): the port's plain backward (``ref.selective_scan_bwd``, and the
autograd wrapper ``ops.selective_scan`` that calls it for CPU tensors)
against ``jax.vjp`` of the JAX package's ``selective_scan_ref``, on the
same inputs made with numpy from a seed.

Tolerance: 1e-4 of the largest |grad| of each input.  Both sides run the
recurrence in fp32 and take its gradient by reverse-mode AD; they sum in
other orders.  With a bf16 ``u`` the port returns ``du`` in bf16, its fp32
``du`` rounded once: it is held against JAX's fp32 gradient at the same
(bf16-valued) ``u``, within half a bf16 ulp more (2**-8 of the value).
JAX's own bf16 ``du`` is not the yardstick: its scan casts ``u`` at two
uses and adds the two bf16 cotangents in bf16, so where they cancel its
error is an ulp of the larger term, not of the sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan_ref as jax_scan
from repro_torch.kernels import ops, ref

NAMES = ("u", "dt", "b", "c", "a_log", "d_skip", "h0")


def inputs(seed, b, s, di, ds, *, h0, dh_last):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.log1p(np.exp(n(b, s, di) - 1.0)).astype(np.float32)
    a_log = (np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32),
                            (di, 1))) + 0.1 * n(di, ds)).astype(np.float32)
    args = [n(b, s, di), dt, n(b, s, ds), n(b, s, ds), a_log, n(di),
            n(b, di, ds) if h0 else None]
    return args, n(b, s, di), (n(b, di, ds) if dh_last else None)


def jax_grads(args, dy, dh_last):
    ja = [None if a is None else jnp.asarray(a) for a in args]
    if ja[6] is None:
        (y, h), vjp = jax.vjp(lambda *x: jax_scan(*x), *ja[:6])
    else:
        (y, h), vjp = jax.vjp(lambda *x: jax_scan(*x), *ja)
    dh = jnp.zeros_like(h) if dh_last is None else jnp.asarray(dh_last)
    got = vjp((jnp.asarray(dy), dh))
    return [np.asarray(g.astype(jnp.float32)) for g in got]


def assert_grads(got, want, names, u_bf16=False):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, name
        lim = 1e-4 * float(np.abs(w).max())
        if name == "u" and u_bf16:
            lim = lim + 2.0 ** -8 * np.abs(w)   # half a bf16 ulp
        err = np.abs(g - w)
        assert (err <= lim).all(), (name, float(err.max()))


CASES = [(2, 37, 6, 5), (1, 48, 16, 16), (3, 21, 10, 3)]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dh_last", [False, True])
@pytest.mark.parametrize("shape", CASES)
def test_plain_backward_matches_jax_vjp(shape, h0, dh_last):
    args, dy, dhl = inputs(sum(shape), *shape, h0=h0, dh_last=dh_last)
    want = jax_grads(args, dy, dhl)
    t = [None if a is None else torch.from_numpy(a) for a in args]
    got = ref.selective_scan_bwd(*t, torch.from_numpy(dy),
                                 None if dhl is None else
                                 torch.from_numpy(dhl))
    names = NAMES if h0 else NAMES[:6]
    assert (got[6] is None) == (not h0)
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    assert_grads([g for g in got if g is not None], want, names)


@pytest.mark.parametrize("h0", [False, True])
def test_autograd_wrapper_with_bf16_u_matches_jax(h0):
    """``ops.selective_scan`` differentiable on CPU tensors: the gradients
    of ``sum(y * dy) + sum(h_last * dh_last)`` in each input's dtype."""
    args, dy, dhl = inputs(7, 2, 40, 12, 16, h0=h0, dh_last=True)
    t = [None if a is None else torch.from_numpy(a) for a in args]
    t[0] = t[0].to(torch.bfloat16)
    args[0] = t[0].float().numpy()   # the bf16 values, in fp32 for JAX
    want = jax_grads(args, dy, dhl)
    leaves = [a.requires_grad_() for a in t if a is not None]
    y, h = ops.selective_scan(*t)
    (torch.sum(y * torch.from_numpy(dy)) +
     torch.sum(h * torch.from_numpy(dhl))).backward()
    assert t[0].grad.dtype == torch.bfloat16
    assert_grads([a.grad for a in leaves], want,
                 NAMES if h0 else NAMES[:6], u_bf16=True)


def test_no_gradient_no_autograd_node():
    """Without an input that requires a gradient the wrapper is the plain
    forward: no graph, the same values."""
    args, _, _ = inputs(3, 1, 9, 4, 2, h0=False, dh_last=False)
    t = [None if a is None else torch.from_numpy(a) for a in args]
    y, h = ops.selective_scan(*t)
    assert y.grad_fn is None and h.grad_fn is None
    with torch.no_grad():
        t[1].requires_grad_()
        y2, _ = ops.selective_scan(*t)
    assert y2.grad_fn is None
    assert torch.equal(y, ref.selective_scan(*t)[0]) and torch.equal(y, y2)


def test_wrapper_gradient_equals_autograd_through_the_plain_scan():
    """The CPU backward is autograd through the plain scan, recomputed:
    the wrapper's gradients equal differentiating ``ref.selective_scan``
    directly, bit for bit."""
    args, dy, _ = inputs(11, 2, 17, 5, 4, h0=True, dh_last=False)
    grads = []
    for fn in (ops.selective_scan, ref.selective_scan):
        t = [torch.from_numpy(a).requires_grad_() for a in args]
        y, _ = fn(*t)
        torch.sum(y * torch.from_numpy(dy)).backward()
        grads.append([a.grad for a in t])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
