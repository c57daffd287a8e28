"""Port parity: the fused DAC residual unit's plain version against the JAX
package's XLA ``_residual_unit`` and its Pallas kernel in interpret mode
(CPU, fp32, atol/rtol 2e-5, the JAX kernel test's limits), plus the
wrapper's CPU dispatch, its input checks, the kernel's weight layout and
the model unit's cache of it.

The reference kernel's other forms: the polynomial snake against JAX's
(f32, within two ulps of max|out|: 4e-7); both snakes on bf16 operands
against the reference kernel's, bit for bit; the exact form with it against
the interpret kernel at "highest" (2e-5); the default form (one bf16 pass)
against a float64 numpy emulation of its rounding points, written here,
one rounding point at a time (1e-5 relative, and one bf16 ulp at a
rounding point), and on bf16 inputs against the interpret kernel at
"default" within 1e-2 · max|out| (on the CPU, JAX's "default" is full
fp32 for fp32 operands, so that bound is the bf16 scale; the emulation is
the tight check).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocodecs_tpu.models.dac import _residual_unit as j_residual_unit
from audiocodecs_tpu.models.dac import _snake_sin2_poly as j_sin2_poly
from audiocodecs_tpu.ops.dac_resunit_pallas import _snake as j_kernel_snake
from audiocodecs_tpu.ops.dac_resunit_pallas import dac_resunit_pallas
from audiocodecs_tpu_torch.models.dac import DecodeForm, ResidualUnit
from audiocodecs_tpu_torch.models.dac import snake as model_snake
from audiocodecs_tpu_torch.ops.dac_resunit import (
    FORMS,
    _check,
    _fragment_index,
    dac_resunit,
    dac_resunit_reference,
    dac_resunit_stages,
    default_errors,
    default_head,
    default_tail,
    pack_resunit_weights,
    snake,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _dac_launches() -> int:
    """The DAC unit's kernel launches in this process, every form."""
    return sum(dac_resunit.launches_by_form.values())


def _unit_params(rng, C):
    """The JAX kernel test's draws: α = |N| + 0.5, small conv weights."""
    return {
        "alpha1": (np.abs(rng.standard_normal(C)) + 0.5).astype(np.float32),
        "conv1": {"w": (rng.standard_normal((7, C, C)) * 0.05).astype(
            np.float32),
            "b": (rng.standard_normal(C) * 0.1).astype(np.float32)},
        "alpha2": (np.abs(rng.standard_normal(C)) + 0.5).astype(np.float32),
        "conv2": {"w": (rng.standard_normal((1, C, C)) * 0.05).astype(
            np.float32),
            "b": (rng.standard_normal(C) * 0.1).astype(np.float32)},
    }


def _port_args(p):
    """The JAX unit's params in the port's layouts (conv ``[Cout, Cin, K]``)."""
    t = torch.from_numpy
    return (t(p["conv1"]["w"].transpose(2, 1, 0).copy()), t(p["conv1"]["b"]),
            t(p["alpha1"]), t(p["conv2"]["w"].transpose(2, 1, 0).copy()),
            t(p["conv2"]["b"]), t(p["alpha2"]))


def _bct(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("T", [20, 700, 1024])
def test_plain_unit_matches_jax_xla_and_pallas(rng, monkeypatch, T,
                                               dilation):
    monkeypatch.delenv("ACX_PALLAS_DAC_RESUNIT", raising=False)  # XLA path
    C = 8
    p = _unit_params(rng, C)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v)) for k, v in p.items()}
    want = np.asarray(j_residual_unit(jnp.asarray(x), jp, dilation))
    kernel = np.asarray(dac_resunit_pallas(
        jnp.asarray(x), jp["conv1"]["w"], jp["conv1"]["b"], jp["alpha1"],
        jp["conv2"]["w"], jp["conv2"]["b"], jp["alpha2"], dilation=dilation,
        tile=256, interpret=True, precision_name="highest"))
    got = dac_resunit_reference(_bct(x), *_port_args(p), dilation)
    got = got.numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == kernel.shape == (2, T, C)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_unit_module_paths_agree(rng, fused):
    """The model's unit, fused (the wrapper's plain version on the CPU) or
    unfused (the plain version itself), passes its weights in the plain
    version's order."""
    C, d = 16, 3
    p = _unit_params(rng, C)
    unit = ResidualUnit(C, d, fused=fused)
    w7, b7, a1, w1, b1, a2 = _port_args(p)
    with torch.no_grad():
        for dst, src in ((unit.conv1.w, w7), (unit.conv1.b, b7),
                         (unit.alpha1, a1), (unit.conv2.w, w1),
                         (unit.conv2.b, b1), (unit.alpha2, a2)):
            dst.copy_(src)
        x = _bct(rng.standard_normal((2, 300, C)).astype(np.float32))
        want = dac_resunit_reference(x, w7, b7, a1, w1, b1, a2, d)
        torch.testing.assert_close(unit(x), want, **TOL)


def test_wrapper_on_cpu_runs_plain_version_without_launching(rng):
    p = _unit_params(rng, 8)
    x = _bct(rng.standard_normal((2, 45, 8)).astype(np.float32))
    before = _dac_launches()
    got = dac_resunit(x, *_port_args(p), 9)
    assert _dac_launches() == before
    torch.testing.assert_close(
        got, dac_resunit_reference(x, *_port_args(p), 9), rtol=0, atol=0)


def test_kernel_input_checks(rng):
    """What the kernel does not take raises before any launch."""
    C = 8
    p = _unit_params(rng, C)
    x = _bct(rng.standard_normal((1, 20, C)).astype(np.float32))
    args = [x, *_port_args(p)]
    _check(*args, 3)
    with pytest.raises(ValueError):  # a bias of the wrong shape
        _check(*args[:2], args[2][:4], *args[3:], 3)
    with pytest.raises(ValueError):  # x without its batch axis
        _check(x[0], *args[1:], 3)
    with pytest.raises(TypeError):
        _check(*[a.double() for a in args], 3)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2)] + args[1:]
    with pytest.raises(ValueError, match="contiguous"):
        _check(*strided, 3)
    with pytest.raises(ValueError):
        _check(*args, 0)
    with pytest.raises(ValueError):
        dac_resunit(*[a.to("meta") for a in args], 3)
    C = 384  # wider than the kernel takes
    wide = [torch.zeros(s) for s in ((1, C, 4), (C, C, 7), (C,), (C,),
                                     (C, C, 1), (C,), (C,))]
    with pytest.raises(ValueError, match="C <= 256"):
        _check(*wide, 1)


@pytest.mark.parametrize("C,Kp,Cp", [(5, 8, 96), (96, 96, 96),
                                     (192, 192, 192), (200, 200, 256)])
def test_pack_resunit_weights_layout(rng, C, Kp, Cp):
    """``w7p [Kp, 7, Cp]`` with ``w7p[c, k, o] = w7[o, c, k]``, ``w1p
    [Kp, Cp]`` with ``w1p[m, o] = w1[o, m, 0]``, padded lanes zero."""
    w7 = torch.from_numpy(rng.standard_normal((C, C, 7)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    w7p, w1p = pack_resunit_weights(w7, w1)
    assert w7p.shape == (Kp, 7, Cp) and w1p.shape == (Kp, Cp)
    assert w7p.dtype == w1p.dtype == torch.float32
    assert w7p.is_contiguous() and w1p.is_contiguous()
    assert torch.equal(w7p[:C, :, :C], w7.permute(1, 2, 0))
    assert torch.equal(w1p[:C, :C], w1[:, :, 0].T)
    for pad in (w7p[C:], w7p[:, :, C:], w1p[C:], w1p[:, C:]):
        assert not pad.any()


def test_unit_packs_once_and_again_after_new_weights(rng):
    """The fused unit builds the kernel's layout on its first forward, keeps
    it across forwards, and rebuilds it when ``load_state_dict`` writes new
    weights; the layout is no state-dict entry."""
    C, d = 16, 3
    unit = ResidualUnit(C, d, fused=True)
    state = dict(zip(("conv1.w", "conv1.b", "alpha1", "conv2.w", "conv2.b",
                      "alpha2"), _port_args(_unit_params(rng, C))))
    unit.load_state_dict(state, strict=True)
    x = _bct(rng.standard_normal((1, 40, C)).astype(np.float32))
    before = pack_resunit_weights.packs
    with torch.inference_mode():
        unit(x)
        first = unit.packed_weights()
        unit(x)
    assert pack_resunit_weights.packs == before + 1
    assert unit.packed_weights() is first
    assert set(unit.state_dict()) == set(state)

    new = dict(zip(state, _port_args(_unit_params(rng, C))))
    unit.load_state_dict(new, strict=True)
    with torch.inference_mode():
        unit(x)
    assert pack_resunit_weights.packs == before + 2
    w7p, w1p = unit.packed_weights()
    want = pack_resunit_weights(new["conv1.w"], new["conv2.w"])
    assert torch.equal(w7p, want[0]) and torch.equal(w1p, want[1])


def test_wrapper_on_cpu_with_packed_pair_equals_plain_version(rng):
    C, d = 12, 9
    p = _unit_params(rng, C)
    args = _port_args(p)
    x = _bct(rng.standard_normal((2, 77, C)).astype(np.float32))
    packed = pack_resunit_weights(args[0], args[3])
    got = dac_resunit(x, *args, d, packed=packed)
    torch.testing.assert_close(got, dac_resunit_reference(x, *args, d),
                               rtol=0, atol=0)


def test_kernel_input_checks_on_the_packed_pair(rng):
    C = 8
    args = [_bct(rng.standard_normal((1, 20, C)).astype(np.float32)),
            *_port_args(_unit_params(rng, C))]
    w7p, w1p = pack_resunit_weights(args[1], args[4])
    _check(*args, 3, (w7p, w1p))
    with pytest.raises(ValueError, match="packed w7"):
        _check(*args, 3, (w7p[:, :, :64], w1p))
    with pytest.raises(ValueError, match="packed w1"):
        _check(*args, 3, (w7p, w1p.T))
    with pytest.raises(TypeError):
        _check(*args, 3, (w7p.double(), w1p))


# ---- the reference kernel's other forms ----------------------------------


def _jax_params(p, dtype=jnp.float32):
    return {k: ({kk: jnp.asarray(vv, dtype) for kk, vv in v.items()}
                if isinstance(v, dict) else jnp.asarray(v, dtype))
            for k, v in p.items()}


def test_poly_snake_matches_jax_forms(rng):
    """The kernel's poly snake against the reference kernel's
    ``_snake(poly=True)`` and the XLA path's ``_snake_sin2_poly``, and the
    model's (round-based) against the latter, in f32 over a range that
    takes the range reduction through many periods."""
    x = (rng.standard_normal((2, 16, 3000)) * 4).astype(np.float32)
    a = (np.abs(rng.standard_normal(16)) + 0.5).astype(np.float32)
    xj, aj = jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(a)
    kernel_form = np.asarray(j_kernel_snake(xj, aj, True)).transpose(0, 2, 1)
    xla_form = np.asarray(xj + j_sin2_poly(aj * xj) / (aj + 1e-9)).transpose(
        0, 2, 1)
    tx, ta = torch.from_numpy(x), torch.from_numpy(a)
    lim = 4e-7 * np.abs(kernel_form).max()
    got = snake(tx, ta, poly=True).numpy()
    assert np.abs(got - kernel_form).max() <= lim
    assert np.abs(got - xla_form).max() <= lim
    got_model = model_snake(tx, ta, poly=True).numpy()
    assert np.abs(got_model - xla_form).max() <= lim
    # the sin form is the exact snake, and the poly is not it
    assert np.abs(got - snake(tx, ta).numpy()).max() > 0


@pytest.mark.parametrize("poly", [False, True])
def test_kernel_snake_on_bf16_matches_jax_kernel_bit_for_bit(rng, poly):
    """On bf16 operands the kernel's snake is the reference kernel's
    ``_snake`` in bf16: the sin form rounds each operation to bf16, the
    poly form rounds α·x, computes in f32 and rounds once."""
    x = (rng.standard_normal((2, 16, 3000)) * 4).astype(np.float32)
    a = (np.abs(rng.standard_normal(16)) + 0.5).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 1), jnp.bfloat16)
    aj = jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(j_kernel_snake(xj, aj, poly).astype(
        jnp.float32)).transpose(0, 2, 1)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = snake(tx, torch.from_numpy(a).to(torch.bfloat16), poly)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                  want)


@pytest.mark.parametrize("dilation", [1, 9])
def test_plain_unit_exact_poly_matches_jax_pallas(rng, dilation):
    C, T = 8, 700
    p = _unit_params(rng, C)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    jp = _jax_params(p)
    want = np.asarray(dac_resunit_pallas(
        jnp.asarray(x), jp["conv1"]["w"], jp["conv1"]["b"], jp["alpha1"],
        jp["conv2"]["w"], jp["conv2"]["b"], jp["alpha2"], dilation=dilation,
        tile=256, interpret=True, precision_name="highest", snake_poly=True))
    got = dac_resunit_reference(_bct(x), *_port_args(p), dilation,
                                snake_poly=True).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, **TOL)


def _np_bf16(a):
    """float64 → bf16 (nearest even, through float32) → float64."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return u.view(np.float32).astype(np.float64)


def _np_snake(v, a):
    a = a[:, None]
    return v + np.sin(a * v) ** 2 / (a + 1e-9)


def _np_conv(h, w, d):
    """[B, C, T] conv with zero padding 3d (or none for k = 1), in float64."""
    B, C, T = h.shape
    K = w.shape[2]
    pad = (K // 2) * d
    hp = np.pad(h, ((0, 0), (0, 0), (pad, pad)))
    out = np.zeros((B, w.shape[0], T))
    for k in range(K):
        out += np.einsum("oc,bct->bot", w[:, :, k], hp[:, :, k * d: k * d + T])
    return out


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
                   - 7)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_plain_default_form_matches_float64_emulation(rng, dilation):
    """The rounding points of the one bf16 pass, emulated in float64:
    h = bf16(snake(x)), the k7 conv of h and bf16(w7) summed, + b7, h2 =
    bf16(snake(·)), the 1×1 of h2 and bf16(w1), + b1, + x. Each stage is
    emulated from the plain version's previous rounding point, so two
    correct roundings that straddle a boundary cost one ulp there and
    nothing downstream."""
    C, T = 24, 500
    p = _unit_params(rng, C)
    x = rng.standard_normal((2, C, T)).astype(np.float32)
    w7, b7, a1, w1, b1, a2 = [a.numpy().astype(np.float64)
                              for a in _port_args(p)]
    tx, args = torch.from_numpy(x), _port_args(p)
    h = snake(tx, args[2]).to(torch.bfloat16).double().numpy()
    h_e = _np_bf16(_np_snake(x.astype(np.float64), a1))
    assert (np.abs(h - h_e) <= _bf16_ulp(h_e)).all()
    h2 = default_head(tx, args[0], args[1], args[2], args[5], dilation)
    v_e = _np_conv(h, _np_bf16(w7), dilation) + b7[None, :, None]
    h2_e = _np_bf16(_np_snake(v_e, a2))
    h2n = h2.double().numpy()
    assert (np.abs(h2n - h2_e) <= _bf16_ulp(h2_e)).all()
    assert (h2n != h2_e).mean() < 1e-3
    out = default_tail(tx, h2, args[3], args[4]).double().numpy()
    out_e = x + (_np_conv(h2n, _np_bf16(w1), 1) + b1[None, :, None])
    assert np.abs(out - out_e).max() <= 1e-5 * np.abs(out_e).max()
    # the plain version is exactly these two stages
    full = dac_resunit_reference(tx, *args, dilation, precision="default")
    assert torch.equal(full, default_tail(tx, h2, args[3], args[4]))
    # and one bf16 pass moves the unit off the exact form, at the bf16 scale
    exact = dac_resunit_reference(tx, *args, dilation).numpy()
    dev = np.abs(full.numpy() - exact).max() / np.abs(exact).max()
    assert 1e-5 < dev < 1e-2


@pytest.mark.parametrize("poly", [False, True])
@pytest.mark.parametrize("dilation", [1, 9])
def test_plain_default_form_on_bf16_matches_jax_interpret(rng, poly,
                                                          dilation):
    C, T = 8, 700
    p = _unit_params(rng, C)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    jp = _jax_params(p, jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(dac_resunit_pallas(
        xb, jp["conv1"]["w"], jp["conv1"]["b"], jp["alpha1"],
        jp["conv2"]["w"], jp["conv2"]["b"], jp["alpha2"], dilation=dilation,
        tile=256, interpret=True, precision_name="default",
        snake_poly=poly).astype(jnp.float32))
    args = [a.to(torch.bfloat16) for a in _port_args(p)]
    xt = _bct(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = dac_resunit_reference(xt, *args, dilation, precision="default",
                                snake_poly=poly)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 1)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_fragment_index_is_the_ptx_a_layout():
    """mma.m16n8k16's A fragment (PTX ISA): lane l = 4g + t holds (g, 2t),
    (g, 2t+1), (g+8, 2t), (g+8, 2t+1), (g, 2t+8), (g, 2t+9), (g+8, 2t+8),
    (g+8, 2t+9) of the 16 × 16 tile."""
    rows, cols = _fragment_index()
    assert rows[0].tolist() == [0, 0, 8, 8, 0, 0, 8, 8]
    assert cols[0].tolist() == [0, 1, 0, 1, 8, 9, 8, 9]
    assert rows[5].tolist() == [1, 1, 9, 9, 1, 1, 9, 9]
    assert cols[5].tolist() == [2, 3, 2, 3, 10, 11, 10, 11]
    cells = {(r, c) for r, c in zip(rows.flatten().tolist(),
                                    cols.flatten().tolist())}
    assert len(cells) == 256  # every cell of the tile once


@pytest.mark.parametrize("C,nq,cp", [(5, 1, 64), (40, 3, 64), (96, 6, 96),
                                     (120, 8, 192), (192, 12, 192),
                                     (200, 13, 256)])
def test_pack_resunit_weights_default_layout(rng, C, nq, cp):
    """``w7f[q, k, t, l, e] = bf16(w7[16t + r, 16q + c, k])`` and
    ``w1f[q, t, l, e] = bf16(w1[16t + r, 16q + c, 0])`` with (r, c) the
    fragment cell of (l, e); zero where (16t + r, 16q + c) lies outside
    C × C."""
    w7 = torch.from_numpy(rng.standard_normal((C, C, 7)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    w7f, w1f = pack_resunit_weights(w7, w1, "default")
    mt = cp // 16
    assert w7f.shape == (nq, 7, mt, 32, 8) and w1f.shape == (nq, mt, 32, 8)
    assert w7f.dtype == w1f.dtype == torch.bfloat16
    assert w7f.is_contiguous() and w1f.is_contiguous()
    rows, cols = _fragment_index()
    pad7 = torch.zeros(cp, 16 * nq, 7, dtype=torch.bfloat16)
    pad7[:C, :C] = w7.to(torch.bfloat16)
    pad1 = torch.zeros(cp, 16 * nq, dtype=torch.bfloat16)
    pad1[:C, :C] = w1[:, :, 0].to(torch.bfloat16)
    for q, k, t in ((0, 0, 0), (nq - 1, 6, mt - 1), (nq // 2, 3, mt // 2)):
        want = pad7[16 * t + rows, 16 * q + cols, k]
        assert torch.equal(w7f[q, k, t], want)
        assert torch.equal(w1f[q, t], pad1[16 * t + rows, 16 * q + cols])


def test_default_form_checks_and_dispatch(rng):
    """bf16 with the exact form raises on every device; the default form on
    CPU tensors runs its plain version and launches nothing; the stages'
    CPU path is the plain version's two halves; the kernel's own checks
    take the default form's packed layout."""
    C = 16
    p = _unit_params(rng, C)
    x = _bct(rng.standard_normal((1, 40, C)).astype(np.float32))
    args = _port_args(p)
    bf = [a.to(torch.bfloat16) for a in (x, *args)]
    with pytest.raises(TypeError, match="precision='default'"):
        dac_resunit(*bf, 3)
    with pytest.raises(ValueError, match="precision"):
        dac_resunit(x, *args, 3, precision="high")
    before = dict(dac_resunit.launches_by_form)
    for xs, ws in ((x, args), (bf[0], bf[1:])):
        for poly in (False, True):
            got = dac_resunit(xs, *ws, 3, precision="default",
                              snake_poly=poly)
            want = dac_resunit_reference(xs, *ws, 3, precision="default",
                                         snake_poly=poly)
            assert got.dtype == xs.dtype and torch.equal(got, want)
            out, h2 = dac_resunit_stages(xs, *ws, 3, snake_poly=poly)
            assert torch.equal(out, want) and h2.dtype == torch.bfloat16
            assert default_errors(out, h2, xs, *ws, 3, poly)["ok"]
    assert dac_resunit.launches_by_form == before
    assert set(before) == set(FORMS)
    w7f, w1f = pack_resunit_weights(args[0], args[3], "default")
    _check(*bf, 3, (w7f, w1f), "default")
    _check(x, *args, 3, (w7f, w1f), "default")
    with pytest.raises(ValueError, match="packed w7"):
        _check(x, *args, 3, pack_resunit_weights(args[0], args[3]),
               "default")
    with pytest.raises(ValueError, match="shared memory"):
        _check(x, *args, 22, None, "default")  # a window past 256 rows
    with pytest.raises(TypeError):  # weights of another dtype than x
        _check(bf[0], *args, 3, None, "default")


@pytest.mark.parametrize("form", [dict(precision="default"),
                                  dict(precision="default", snake_poly=True),
                                  dict(snake_poly=True)])
def test_new_forms_refuse_a_gradient(rng, form):
    """Only the exact sin form is differentiable; the others are for
    inference, as the reference's kernel, which has no VJP."""
    p = _unit_params(rng, 8)
    x = _bct(rng.standard_normal((1, 30, 8)).astype(np.float32))
    x.requires_grad_()
    y = dac_resunit(x, *_port_args(p), 3, **form)
    with pytest.raises(RuntimeError, match="inference only"):
        y.sum().backward()


def test_unit_packs_again_when_its_form_changes(rng):
    """The packed layout's key holds the form's precision."""
    C, d = 16, 1
    unit = ResidualUnit(C, d, fused=True)
    unit.load_state_dict(dict(zip(
        ("conv1.w", "conv1.b", "alpha1", "conv2.w", "conv2.b", "alpha2"),
        _port_args(_unit_params(rng, C)))), strict=True)
    first = unit.packed_weights()
    assert unit.packed_weights() is first
    unit.form = DecodeForm(torch.bfloat16, "default", True)
    second = unit.packed_weights()
    assert second is not first and second[0].dtype == torch.bfloat16
    x = _bct(rng.standard_normal((1, 40, C)).astype(np.float32))
    with torch.inference_mode():
        y = unit(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
