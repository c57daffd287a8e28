"""The kernels' autograd Functions on the CPU: each backward recomputes
through the plain version, so its gradient is checked with
``torch.autograd.gradcheck`` in float64 at tiny shapes (the plain versions
are dtype-generic; only the card's kernels need float32). The same
Functions run on the card, where the forward launches the kernel
(``tests/test_torch_cuda.py``).

Also: the residual block's halo carries gradient back into ``x``; a packed
weight layout is a detached side input; and a block's packed weights are
rebuilt once after each ``optimizer.step()``, never reused stale.
"""

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck

from audiocodecs_tpu_torch.models.dac import ResidualUnit
from audiocodecs_tpu_torch.nn.lstm import bilstm, lstm
from audiocodecs_tpu_torch.nn.seanet import (
    ResBlock,
    SEANetConfig,
    _apply_resnet,
    _resnet_plain,
)
from audiocodecs_tpu_torch.ops.dac_resunit import (
    dac_resunit,
    dac_resunit_reference,
    pack_resunit_weights,
)
from audiocodecs_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence,
    lstm_recurrence_reference,
)
from audiocodecs_tpu_torch.ops.seanet_resblock import (
    pack_resblock_weights,
    seanet_resblock,
    seanet_resblock_packed,
    seanet_resblock_reference,
)
from zoo_pairs import one_thread  # noqa: F401 (autouse)

F64 = torch.float64


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale).requires_grad_()


def _lstm_args(rng, T, B, H):
    return (_t(rng, T, B, 4 * H), _t(rng, H, 4 * H, scale=0.5),
            _t(rng, B, H, scale=0.5), _t(rng, B, H, scale=0.5))


@pytest.mark.parametrize("T,B,H", [(1, 1, 2), (5, 2, 3), (9, 3, 4)])
def test_lstm_recurrence_gradcheck(rng, T, B, H):
    """All four inputs (``h0`` and ``c0`` included), all three outputs."""
    assert gradcheck(lstm_recurrence, _lstm_args(rng, T, B, H))


@pytest.mark.parametrize("used", ["ys", "h_T", "c_T"])
def test_lstm_recurrence_gradcheck_one_output(rng, used):
    """Outputs the loss does not use get no gradient (None) and cost
    nothing in the recompute's VJP."""
    i = ("ys", "h_T", "c_T").index(used)
    assert gradcheck(lambda *a: lstm_recurrence(*a)[i],
                     _lstm_args(rng, 6, 2, 3))


def test_lstm_recurrence_gradient_equals_plain_autograd(rng):
    args = _lstm_args(rng, 7, 2, 5)
    w = [torch.from_numpy(rng.standard_normal(s)) for s in
         ((7, 2, 5), (2, 5), (2, 5))]

    def grads(fn):
        out = fn(*args)
        loss = sum((o * wi).sum() for o, wi in zip(out, w))
        return torch.autograd.grad(loss, args)

    for g, want in zip(grads(lstm_recurrence),
                       grads(lstm_recurrence_reference)):
        torch.testing.assert_close(g, want, rtol=0, atol=1e-12)


def _lstm_params(rng, layers, cin, H, bidirectional=False):
    def one(c):
        return {"w_ih": _t(rng, c, 4 * H, scale=0.4),
                "w_hh": _t(rng, H, 4 * H, scale=0.4),
                "b": _t(rng, 4 * H, scale=0.1)}

    if bidirectional:
        return [{d: one(cin if li == 0 else 2 * H) for d in ("fwd", "bwd")}
                for li in range(layers)]
    return [one(cin if li == 0 else H) for li in range(layers)]


def test_stacked_lstm_gradcheck_with_state(rng):
    """``nn/lstm.py::lstm`` with a carried ``(h, c)`` a layer: the
    gradient reaches the input, every weight and both states."""
    x = _t(rng, 2, 4, 3)
    params = _lstm_params(rng, 2, 3, 2)
    state = [(_t(rng, 2, 2, scale=0.5), _t(rng, 2, 2, scale=0.5))
             for _ in range(2)]
    leaves = [x] + [p[k] for p in params for k in ("w_ih", "w_hh", "b")] + [
        s for hc in state for s in hc]

    def f(x, *rest):
        ps = [dict(zip(("w_ih", "w_hh", "b"), rest[3 * i:3 * i + 3]))
              for i in range(2)]
        st = [(rest[6 + 2 * i], rest[7 + 2 * i]) for i in range(2)]
        y, hc = lstm(x, ps, st)
        return (y, *[t for pair in hc for t in pair])

    assert gradcheck(f, leaves)


def test_bilstm_gradcheck_reverse_direction(rng):
    """A bidirectional stack: the reverse direction runs on ``x`` flipped
    in time and flips its output back; the gradient goes through both
    flips into ``x`` and the reverse weights."""
    x = _t(rng, 2, 5, 3)
    params = _lstm_params(rng, 2, 3, 2, bidirectional=True)
    names = [(li, d, k) for li in range(2) for d in ("fwd", "bwd")
             for k in ("w_ih", "w_hh", "b")]
    leaves = [x] + [params[li][d][k] for li, d, k in names]

    def f(x, *ws):
        ps = [{"fwd": {}, "bwd": {}} for _ in range(2)]
        for (li, d, k), w in zip(names, ws):
            ps[li][d][k] = w
        return bilstm(x, ps)

    assert gradcheck(f, leaves)
    # the reverse direction's gradient, against a loop written out by hand
    # with the plain recurrence on the flipped input
    y = f(x, *leaves[1:])
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    got = torch.autograd.grad((y * g).sum(), leaves[1:])
    want = torch.autograd.grad((_bilstm_by_hand(x, params) * g).sum(),
                               leaves[1:])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def _bilstm_by_hand(x, params):
    def layer(x, p):
        B, T, _ = x.shape
        H = p["w_hh"].shape[0]
        gx = (x @ p["w_ih"] + p["b"]).transpose(0, 1)
        z = x.new_zeros(B, H)
        return lstm_recurrence_reference(gx, p["w_hh"], z, z)[0].transpose(0, 1)

    for p in params:
        fwd = layer(x, p["fwd"])
        bwd = layer(torch.flip(x, dims=(1,)), p["bwd"]).flip(1)
        x = torch.cat([fwd, bwd], dim=-1)
    return x


def _block_weights(rng, C):
    Hc = C // 2
    return [_t(rng, Hc, C, 3, scale=0.4), _t(rng, Hc, scale=0.1),
            _t(rng, C, Hc, 1, scale=0.4), _t(rng, C, scale=0.1),
            _t(rng, C, C, 1, scale=0.4), _t(rng, C, scale=0.1)]


def test_seanet_resblock_gradcheck(rng):
    x, halo = _t(rng, 2, 4, 6), _t(rng, 2, 4, 2)
    assert gradcheck(seanet_resblock, [x, halo, *_block_weights(rng, 4)])


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("T", [1, 2, 7])
def test_block_gradient_reaches_x_through_the_halo(rng, pad_mode, T):
    """``_apply_resnet`` builds the halo from ``x[..., :3]`` (reflect or
    zero); the fused path's gradient equals the unfused path's, which pads
    inside its convs. With the halo's gradient dropped, ``x``'s first
    samples would differ (reflect mode)."""
    cfg = SEANetConfig(pad_mode=pad_mode)
    blk = ResBlock(4, cfg).double()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * 0.4))
    x = _t(rng, 2, 4, T)
    assert gradcheck(lambda x: _apply_resnet(x, blk, cfg, (1, 1)), [x])
    g = torch.from_numpy(rng.standard_normal((2, 4, T)))
    got = torch.autograd.grad((_apply_resnet(x, blk, cfg, (1, 1)) * g).sum(),
                              [x, *blk.parameters()])
    want = torch.autograd.grad((_resnet_plain(x, blk, cfg, (1, 1)) * g).sum(),
                               [x, *blk.parameters()])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    if pad_mode == "reflect":
        # the halo's own share of x's gradient is not zero
        halo = torch.zeros(2, 4, 2, dtype=F64, requires_grad=True)
        xs = x.detach().requires_grad_()
        out = seanet_resblock(xs, halo, *[p for c in (*blk.block, blk.shortcut)
                                          for p in (c.w, c.b)])
        g_halo, = torch.autograd.grad((out * g).sum(), [halo])
        assert float(g_halo.abs().max()) > 0


def test_seanet_resblock_packed_gradcheck(rng):
    """B3: the packed TPU kernel's layouts go through B2's Function after
    their layout copies; the gradient flows back to those layouts."""
    C = 4
    args = [_t(rng, 2, 5, C), _t(rng, 3, C, 2, scale=0.4),
            _t(rng, 2, scale=0.1), _t(rng, 2, C, scale=0.4),
            _t(rng, C, scale=0.1), _t(rng, C, C, scale=0.4),
            _t(rng, C, scale=0.1)]
    assert gradcheck(seanet_resblock_packed, args)


def test_packed_weights_are_a_detached_side_input(rng):
    """B2 and B4 given ``packed``: the gradient is the same as without it,
    and the packed tensors take none."""
    x, halo = _t(rng, 2, 8, 5), _t(rng, 2, 8, 2)
    w = _block_weights(rng, 8)
    packed = pack_resblock_weights(w[0], w[2], w[4])
    assert not any(t.requires_grad for t in packed)
    assert gradcheck(lambda *a: seanet_resblock(*a, packed=packed),
                     [x, halo, *w])
    g = torch.from_numpy(rng.standard_normal((2, 8, 5)))
    got = torch.autograd.grad((seanet_resblock(x, halo, *w, packed=packed)
                               * g).sum(), [x, halo, *w])
    want = torch.autograd.grad((seanet_resblock_reference(x, halo, *w)
                                * g).sum(), [x, halo, *w])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)

    C, d = 4, 2
    xu = _t(rng, 1, C, 9)
    wu = [_t(rng, C, C, 7, scale=0.3), _t(rng, C, scale=0.1),
          torch.from_numpy(np.abs(rng.standard_normal(C)) + 0.5)
          .requires_grad_(), _t(rng, C, C, 1, scale=0.3),
          _t(rng, C, scale=0.1),
          torch.from_numpy(np.abs(rng.standard_normal(C)) + 0.5)
          .requires_grad_()]
    upacked = pack_resunit_weights(wu[0], wu[3])
    assert not any(t.requires_grad for t in upacked)
    assert gradcheck(lambda *a: dac_resunit(*a, d, packed=upacked),
                     [xu, *wu])
    gu = torch.from_numpy(rng.standard_normal((1, C, 9)))
    got = torch.autograd.grad((dac_resunit(xu, *wu, d, packed=upacked)
                               * gu).sum(), [xu, *wu])
    want = torch.autograd.grad((dac_resunit_reference(xu, *wu, d)
                                * gu).sum(), [xu, *wu])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("d", [1, 3])
def test_dac_resunit_gradcheck(rng, d):
    """All of ``x``, both convs and both ``alpha``s."""
    C = 3
    args = [_t(rng, 2, C, 8), _t(rng, C, C, 7, scale=0.3),
            _t(rng, C, scale=0.1),
            torch.from_numpy(np.abs(rng.standard_normal(C)) + 0.5)
            .requires_grad_(),
            _t(rng, C, C, 1, scale=0.3), _t(rng, C, scale=0.1),
            torch.from_numpy(np.abs(rng.standard_normal(C)) + 0.5)
            .requires_grad_()]
    assert gradcheck(lambda *a: dac_resunit(*a, d), args)


@pytest.mark.parametrize("foreach", [False, True])
def test_block_repacks_once_after_each_optimizer_step(rng, foreach):
    """An optimizer's in-place update bumps each weight's version, so the
    next ``packed_weights()`` builds the layout of the new weights, once a
    step however often it is asked for, under ``no_grad``. Both of Adam's
    update paths (a loop, and the foreach ops the card takes by default)."""
    blk = ResBlock(8, SEANetConfig())
    unit = ResidualUnit(8, 3, fused=True)
    for m in (blk, unit):
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * 0.3))
    params = [*blk.parameters(), *unit.parameters()]
    opt = torch.optim.Adam(params, lr=1e-2, foreach=foreach)

    def packs():
        return pack_resblock_weights.packs, pack_resunit_weights.packs

    for _ in range(3):
        before = packs()
        for _ in range(2):  # asked for twice a step: built once
            pb, pu = blk.packed_weights(), unit.packed_weights()
        assert packs() == (before[0] + 1, before[1] + 1)
        assert not any(t.requires_grad for t in (*pb, *pu))
        for got, want in zip(pb, pack_resblock_weights(
                blk.block[0].w, blk.block[1].w, blk.shortcut.w)):
            assert torch.equal(got, want)
        for got, want in zip(pu, pack_resunit_weights(unit.conv1.w,
                                                      unit.conv2.w)):
            assert torch.equal(got, want)
        opt.zero_grad()
        loss = sum((p * p).sum() for p in params)
        loss.backward()
        opt.step()
    # the last step's layouts, then no step and no new pack
    blk.packed_weights()
    unit.packed_weights()
    before = packs()
    blk.packed_weights()
    unit.packed_weights()
    assert packs() == before
