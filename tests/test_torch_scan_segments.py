"""The selective-scan backward's decomposition on the CPU (the training
path, ROADMAP A14; row 9b's redesign, B17): the host plan
(``kernels.selective_scan.bwd_plan``) as a pure function of the shape, and
a plain-PyTorch walk of the kernel's algorithm -- segments swept forward
from zero (the first from ``h0``) with their transfers, an ordered carry
over the segments, then every segment walked back from its carried start
state and adjoint, chunk by chunk -- against ``ref.selective_scan_bwd``
and ``jax.vjp`` of the JAX package's ``selective_scan_ref``, on the same
inputs made with numpy from a seed.

Tolerance: 1e-4 of the largest |grad| of each input, as
``tests/test_torch_scan_grad.py``: all three run the recurrence in fp32
and sum in other orders (the walk's carry composes segment transfers where
the others sum strictly in sequence).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan_ref as jax_scan
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as scan

NAMES = ("u", "dt", "b", "c", "a_log", "d_skip", "h0")
GRADS = ("du", "ddt", "db", "dc", "da_log", "dd_skip", "dh0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this file runs, so that it shares the cores
    with the other workers' files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    n_in = 6 if ja[6] is None else 7
    (_, h), vjp = jax.vjp(lambda *x: jax_scan(*x), *ja[:n_in])
    dh = jnp.zeros_like(h) if dh_last is None else jnp.asarray(dh_last)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), dh))]


def segmented_bwd(plan, u, dt, b, c, a_log, d_skip, h0, dy, dh_last):
    """The kernel's algorithm in plain PyTorch, fp32, vectorised over
    (B, di, ds) at each step; returns what ``selective_scan_bwd`` does."""
    bsz, seq, di = u.shape
    ds = b.shape[-1]
    u, a = u.float(), -torch.exp(a_log)
    x = dt * u
    L, T, n_seg = plan.seg_len, plan.chunk, plan.n_seg
    zeros = torch.zeros(bsz, di, ds)
    hck, qck = {}, {}
    transfer, h_end, g_zero = [], [], []
    # the sweep: each segment forward from zero (the first from h0), its
    # chunk-start states and their transfers from the segment's start
    for k in range(n_seg):
        h = h0.clone() if k == 0 and h0 is not None else zeros.clone()
        q, gz = torch.ones(bsz, di, ds), zeros.clone()
        for t in range(k * L, min(seq, (k + 1) * L)):
            if t % T == 0:
                hck[t // T], qck[t // T] = h.clone(), q.clone()
            e = torch.exp(dt[:, t, :, None] * a)
            h = e * h + x[:, t, :, None] * b[:, t, None, :]
            q = q * e
            gz = gz + dy[:, t, :, None] * c[:, t, None, :] * q
        transfer.append(q)
        h_end.append(h)
        g_zero.append(gz)
    # the ordered carry: true start states forward, adjoints backward
    h_start, g_in = [None] * n_seg, [None] * n_seg
    for k in range(1, n_seg):
        h_start[k] = h_end[0] if k == 1 else \
            transfer[k - 1] * h_start[k - 1] + h_end[k - 1]
    g_in[-1] = zeros.clone() if dh_last is None else dh_last.clone()
    for k in range(n_seg - 1, 0, -1):
        g_in[k - 1] = transfer[k] * g_in[k] + g_zero[k]
    # the walks: each segment's chunks last to first
    du, ddt = torch.zeros(bsz, seq, di), torch.zeros(bsz, seq, di)
    db, dc = torch.zeros(bsz, seq, ds), torch.zeros(bsz, seq, ds)
    da_part = torch.zeros(bsz, n_seg, di, ds)
    dd_part = torch.zeros(bsz, n_seg, di)
    dh0 = None
    for k in range(n_seg):
        g = g_in[k]
        t_end = min(seq, (k + 1) * L)
        for ch in reversed(range(k * L // T, -(-t_end // T))):
            h = hck[ch] if k == 0 else hck[ch] + qck[ch] * h_start[k]
            steps = range(ch * T, min(t_end, (ch + 1) * T))
            es, hs = [], [h]
            for t in steps:
                es.append(torch.exp(dt[:, t, :, None] * a))
                hs.append(es[-1] * hs[-1] + x[:, t, :, None] * b[:, t, None, :])
            for j in reversed(range(len(steps))):
                t = steps[j]
                g = g + dy[:, t, :, None] * c[:, t, None, :]
                eh = es[j] * hs[j]
                db[:, t] = (g * x[:, t, :, None]).sum(1)
                dc[:, t] = (dy[:, t, :, None] * hs[j + 1]).sum(1)
                du[:, t] = dt[:, t] * (g * b[:, t, None, :]).sum(-1) \
                    + d_skip * dy[:, t]
                ddt[:, t] = (g * (a * eh + u[:, t, :, None]
                                  * b[:, t, None, :])).sum(-1)
                da_part[:, k] += g * dt[:, t, :, None] * eh
                dd_part[:, k] += dy[:, t] * u[:, t]
                g = es[j] * g
        if k == 0 and h0 is not None:
            dh0 = g
    da_log = da_part.sum((0, 1)) * a
    return du, ddt, db, dc, da_log, dd_part.sum((0, 1)), dh0


def assert_close(got, want, names, du_ulp=0.0):
    """Each gradient within 1e-4 of the largest of ``want``'s; ``du`` also
    within ``du_ulp`` of each value (a bf16 ulp where ``want`` rounded its
    fp32 ``du`` to bf16)."""
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        if not g.size:
            continue
        lim = 1e-4 * float(np.abs(w).max())
        if name == "du":
            lim = lim + du_ulp * np.abs(w)
        err = np.abs(g - w)
        assert (err <= lim).all(), (name, float(err.max()))


# (S, ds, h0, dh_last) at a ragged d_inner (70: one and a bit of the
# walk's 64-channel blocks) and B = 2, with the segments cut to three
# chunks (L = 24): S = 1, L - 1, L, L + 1 and 3L + 5, each ds of 1, 5 and
# 16 (states past ds padded), h0 and dh_last on and off in turn
SEG = 3 * scan.BWD_CHUNK
EDGE_STEPS = (1, SEG - 1, SEG, SEG + 1, 3 * SEG + 5)
EDGES = [(s, ds, (j + m) % 2 == 0, (j + m) % 4 < 2)
         for j, s in enumerate(EDGE_STEPS) for m, ds in enumerate((1, 5, 16))]


@pytest.mark.parametrize("seq,ds,h0,dh_last", EDGES)
def test_segmented_walk_matches_plain_and_jax(seq, ds, h0, dh_last):
    bsz, di = 2, 70
    args, dy, dhl = inputs(seq * 16 + ds, bsz, seq, di, ds, h0=h0,
                           dh_last=dh_last)
    plan = dataclasses.replace(scan.bwd_plan(bsz, seq, di, ds),
                               seg_len=SEG, n_seg=-(-seq // SEG))
    t = [None if a is None else torch.from_numpy(a) for a in args]
    dyt = torch.from_numpy(dy)
    dht = None if dhl is None else torch.from_numpy(dhl)
    got = segmented_bwd(plan, *t, dyt, dht)
    want = ref.selective_scan_bwd(*t, dyt, dht)
    names = GRADS if h0 else GRADS[:6]
    assert (got[6] is None) == (not h0)
    assert_close([g for g in got if g is not None],
                 [w.numpy() for w in want if w is not None], names)
    assert_close([g for g in got if g is not None], jax_grads(args, dy, dhl),
                 names)


@pytest.mark.parametrize("bsz,seq,di,ds", [(2, 37, 70, 5), (1, 300, 4100, 16),
                                           (3, 17, 33, 1)])
def test_segmented_walk_at_the_plans_own_cut(bsz, seq, di, ds):
    """The walk at the segments the plan picks (one chunk a segment at
    small di; five at 1 x 300 x 4,100, the last segment ragged) with h0
    and dh_last, against the plain backward."""
    args, dy, dhl = inputs(seq + di, bsz, seq, di, ds, h0=True,
                           dh_last=True)
    plan = scan.bwd_plan(bsz, seq, di, ds)
    t = [torch.from_numpy(a) for a in args]
    got = segmented_bwd(plan, *t, torch.from_numpy(dy),
                        torch.from_numpy(dhl))
    want = ref.selective_scan_bwd(*t, torch.from_numpy(dy),
                                  torch.from_numpy(dhl))
    assert_close(got, [w.numpy() for w in want], GRADS)


@pytest.mark.parametrize("bsz,seq,di,ds,seg_len,n_seg", [
    # enough walk blocks: one segment
    (4, 512, 8192, 16, 512, 1),
    # B = 1 at full width: 128 blocks a segment, four segments of 128
    # chunks
    (1, 4096, 8192, 16, 1024, 4),
    # equal whole chunks, the last segment ragged (300 = 4 x 80 - 20)
    (1, 300, 8192, 16, 80, 4),
    # small problems: a segment a chunk
    (2, 37, 70, 5, 8, 5), (2, 16, 64, 16, 8, 2), (3, 1, 8192, 1, 8, 1),
    # an empty sequence: one empty segment
    (1, 0, 64, 16, 8, 1)])
def test_bwd_plan(bsz, seq, di, ds, seg_len, n_seg):
    plan = scan.bwd_plan(bsz, seq, di, ds)
    assert (plan.seg_len, plan.n_seg) == (seg_len, n_seg)
    assert plan.seg_len % plan.chunk == 0 and plan.chunk == scan.BWD_CHUNK
    assert (plan.n_seg - 1) * plan.seg_len < max(seq, 1) <= \
        plan.n_seg * plan.seg_len
    blocks = -(-di // scan.BWD_CHANNELS)
    assert plan.walk_grid == (blocks, n_seg, bsz)
    assert plan.sweep_grid == (-(-di // scan.BWD_SWEEP_CHANNELS), n_seg, bsz)
    chunks = -(-seq // scan.BWD_CHUNK)
    many = n_seg > 1
    assert plan.scratch == {
        "hck": (bsz, chunks, di, 16),
        "qck": (bsz, chunks, di, 16) if many else (0,),
        "summ": (bsz, n_seg, 3, di, 16) if many else (0,),
        "carry": (bsz, n_seg, 2, di, 16) if many else (0,),
        "part": (blocks, bsz, seq, 2, ds),
        "da_part": (bsz, n_seg, di, ds), "dd_part": (bsz, n_seg, di)}


def test_bwd_plan_is_a_function_of_the_shape_alone():
    """The plan, and with it every summation order, comes from (B, S, di,
    ds): equal shapes give equal plans, and one more segment is added only
    while the walk blocks stay under ``BWD_BLOCKS``."""
    assert scan.bwd_plan(1, 4096, 8192, 16) == scan.bwd_plan(1, 4096, 8192,
                                                             16)
    for bsz in (1, 2, 3, 4, 8):
        plan = scan.bwd_plan(bsz, 4096, 8192, 16)
        blocks = bsz * plan.channel_blocks
        assert blocks * plan.n_seg >= scan.BWD_BLOCKS
        assert plan.n_seg == 1 or blocks * (plan.n_seg - 1) < \
            scan.BWD_BLOCKS


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_card_edge_table_covers_the_plans_edges():
    """``chip_smoke.SCAN_BWD_EDGES``, which phase 13 and the card-only test
    hold the kernel to, reaches each edge of the plan's cut: one step; a
    last segment of one step and ragged ones; segments of one chunk and of
    many; several segments at B > 1; d_inner off the walk's channel block;
    ds below 16 (ones that pad a lane's states); both u dtypes; h0 and
    dh_last each on and off.  Its inputs have the shapes and dtypes the
    case names, and the plain backward agrees with the walk of the
    algorithm on the smallest."""
    edges = _chip_smoke().SCAN_BWD_EDGES
    plans = [scan.bwd_plan(b, s, di, ds) for b, s, di, ds, *_ in edges]
    last = [s - (p.n_seg - 1) * p.seg_len for (_, s, *_), p in
            zip(edges, plans)]
    assert any(s == 1 for _, s, *_ in edges)
    assert any(n == 1 and p.n_seg > 1 for n, p in zip(last, plans))
    assert any(0 < n < p.seg_len and p.seg_len > p.chunk
               for n, p in zip(last, plans))
    assert any(p.seg_len == p.chunk and p.n_seg > 2 for p in plans)
    assert any(p.seg_len >= 8 * p.chunk and p.n_seg > 1 for p in plans)
    assert any(b > 1 and p.n_seg > 1 for (b, *_), p in zip(edges, plans))
    assert any(di % scan.BWD_CHANNELS for _, _, di, *_ in edges)
    assert {1, 16} <= {ds for _, _, _, ds, *_ in edges}
    assert any(ds % 4 for _, _, _, ds, *_ in edges)
    assert {e[4] for e in edges} == {torch.float32, torch.bfloat16}
    assert {e[5] for e in edges} == {e[6] for e in edges} == {True, False}
    for case in edges:
        b, s, di, ds, u_dtype, with_h0, with_dh = case
        if s * di > 40_000:
            continue
        call = _chip_smoke().scan_bwd_edge_call(case, "cpu")
        assert call[0].dtype == u_dtype and call[0].shape == (b, s, di)
        assert (call[6] is None) == (not with_h0)
        assert (call[8] is None) == (not with_dh)
        want = ref.selective_scan_bwd(*call)
        got = segmented_bwd(scan.bwd_plan(b, s, di, ds),
                            call[0].float(), *call[1:])
        assert_close([g for g in got if g is not None],
                     [w.float().numpy() for w in want if w is not None],
                     [n for n, w in zip(GRADS, want) if w is not None],
                     du_ulp=2.0 ** -7 if u_dtype == torch.bfloat16 else 0.0)
