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

import re

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
from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.ops._build import CSRC
from audiocodecs_tpu_torch.ops.dac_resunit import (
    FORMS,
    _bf16,
    _check,
    _head_from,
    _mma_channels,
    _window_rows,
    dac_resunit,
    dac_resunit_reference,
    dac_resunit_stages,
    default_errors,
    default_head,
    default_tail,
    operand_offsets,
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


def _kernel_make_desc():
    """``sm90::make_desc`` of ``csrc/sm90.cuh`` (the descriptor of both
    one-pass kernels) as a Python function: its return expression with the
    ``(uint64_t)`` casts dropped is Python."""
    src = (CSRC / "sm90.cuh").read_text()
    body = re.search(r"uint64_t make_desc\(uint32_t start, uint32_t lbo,\s*"
                     r"uint32_t sbo\) \{\s*return (.*?);\s*\}", src, re.S)
    expr = "(" + body.group(1).replace("(uint64_t)", "") + ")"
    return lambda start, lbo, sbo: eval(expr, {}, dict(start=start, lbo=lbo,
                                                        sbo=sbo))


@pytest.mark.parametrize("rows,lbo,sbo", [(64, 2912, 128), (64, 1024, 128),
                                           (192, 3072, 128)])
def test_operand_offsets_is_the_wgmma_k_major_layout(rows, lbo, sbo):
    """wgmma's K-major operand without swizzle, as the PTX ISA defines it
    (the matrix descriptor and the canonical layouts of its shared-memory
    operands): 8-row x 16-byte core matrices of 128 contiguous bytes, rows
    16 bytes apart; the stride byte offset (SBO) between core matrices
    along M/N, the leading byte offset (LBO) between the two along K. The
    window (LBO = 16 · its plane rows), h2 (LBO = 1024) and a weight tap at
    CP = 192 (LBO = 3072). The kernel's descriptor encodes the ISA's fields:
    start address >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45,
    no swizzle (bits 62-63 zero); one unit added to the start field moves
    a window with SBO = 128 on by one row, which is how a tap reads it at
    a row offset of k·d."""
    off = operand_offsets(rows, lbo, sbo)
    assert off.shape == (rows, 16)
    # the ISA's core matrix 0: element (r, c) at byte 16 r + 2 c
    assert [off[0, 0], off[0, 7], off[1, 0], off[7, 0], off[7, 7]] == [
        0, 14, 16, 112, 126]
    assert sorted(off[:8, :8].flatten().tolist()) == list(range(0, 128, 2))
    # the next core matrix along M/N at SBO, along K at LBO
    assert off[8, 0] == sbo and off[0, 8] == lbo
    assert off[15, 15] == sbo + 112 + lbo + 14
    assert len(set(off.flatten().tolist())) == rows * 16  # no overlap

    make_desc = _kernel_make_desc()
    for start in (0, 16, 1024 * 16 + 48):
        desc = make_desc(start, lbo, sbo)
        assert desc & 0x3FFF == start >> 4
        assert (desc >> 16) & 0x3FFF == lbo >> 4
        assert (desc >> 32) & 0x3FFF == sbo >> 4
        assert desc >> 62 == 0  # no swizzle
        for shift in (1, 9, 54):  # k·d rows: the start field + k·d
            moved = make_desc(start + 16 * shift, lbo, sbo)
            assert moved == desc + shift
            if sbo == 128:  # rows contiguous: the shifted operand is the
                # window's rows k·d on
                longer = operand_offsets(rows + shift, lbo, sbo)
                assert torch.equal(longer[shift:], off + 16 * shift)


@pytest.mark.parametrize("C,nq,cp", [(5, 1, 48), (40, 3, 48), (96, 6, 96),
                                     (120, 8, 192), (192, 12, 192),
                                     (200, 13, 256)])
def test_pack_resunit_weights_default_layout(rng, C, nq, cp):
    """``w7f[q, k, h, o, e] = bf16(w7[o, 16q + 8h + e, k])`` and
    ``w1f[q, h, o, e] = bf16(w1[o, 16q + 8h + e, 0])``, zero outside
    C × C; each tap read through its descriptor (start k · CP · 32 bytes
    into the chunk, LBO = CP · 16, SBO = 128) is the [CP, 16] B operand
    ``bf16(w7[:, 16q:16q + 16, k])``."""
    w7 = torch.from_numpy(rng.standard_normal((C, C, 7)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    w7f, w1f = pack_resunit_weights(w7, w1, "default")
    assert w7f.shape == (nq, 7, 2, cp, 8) and w1f.shape == (nq, 2, cp, 8)
    assert w7f.dtype == w1f.dtype == torch.bfloat16
    assert w7f.is_contiguous() and w1f.is_contiguous()
    pad7 = torch.zeros(cp, 16 * nq, 7, dtype=torch.bfloat16)
    pad7[:C, :C] = w7.to(torch.bfloat16)
    pad1 = torch.zeros(cp, 16 * nq, dtype=torch.bfloat16)
    pad1[:C, :C] = w1[:, :, 0].to(torch.bfloat16)
    idx = operand_offsets(cp, cp * 16, 128) // 2
    for q in (0, nq // 2, nq - 1):
        chunk = w7f[q].flatten()
        for k in range(7):
            want = pad7[:, 16 * q:16 * q + 16, k]
            assert torch.equal(chunk[k * cp * 16 + idx], want)
            assert torch.equal(w7f[q, k].permute(1, 0, 2).reshape(cp, 16),
                               want)
        assert torch.equal(w1f[q].flatten()[idx], pad1[:, 16 * q:16 * q + 16])


def _gather(flat, start: int, rows: int, lbo: int, sbo: int):
    """The [..., rows, 16] operand that a descriptor (start, LBO, SBO, in
    bytes) reads from ``flat`` [..., bf16 elements]."""
    return flat[..., (start + operand_offsets(rows, lbo, sbo)) // 2]


def _emulate_operands(x, w7, b7, alpha1, w1, b1, alpha2, d, poly):
    """The default form's operands as the kernel addresses them
    (``csrc/dac_resunit.cu``, namespace ``mma``), in torch on the CPU.

    The transform warps' window of chunk q of tile (b, t0): unit
    u = h·W + j (W = 128 + 6d) holds bf16(snake(x[b, 16q + 8h + e, p],
    α1)) at p = t0 − 3d + j, zero where p is outside [0, T) or the channel
    ≥ C, at byte (h · rows + j) · 16 + 2e of the stage's window; rows past
    W are never written (NaN here, so a read of one shows). Consumer
    warpgroup wg reads tap k through the descriptor (start (64·wg + k·d) ·
    16, LBO = rows · 16, SBO = 128), and the tap's weights from the packed
    chunk (start k · CP · 32, LBO = CP · 16, SBO = 128). h2 is written at
    ((m // 8) · 64 + t) · 16 + 2 (m % 8) of a warpgroup's staging buffer
    and read by chunk j at start j · 2048 (LBO = 1024, SBO = 128), beside
    w1's chunk j from its ring stage.

    Returns, for each tile, warpgroup, chunk and tap, the A and B operands
    of the k7, the sums of both convs in float64, and what the 1×1 reads
    of h2 (from the plain h2, as the kernel's own h2 is checked on the
    card)."""
    B, C, T = x.shape
    cp, nq = _mma_channels(C), -(-C // 16)
    W, rows = 128 + 6 * d, _window_rows(d)
    ntt = -(-T // 128)
    h_full = _bf16(snake(x, alpha1, poly))  # elementwise: the transform's
    u = torch.arange(2 * W)
    hh, j = (u >= W).long(), u - (u >= W).long() * W
    tiles = torch.arange(B * ntt)
    b, t0 = tiles // ntt, (tiles % ntt) * 128
    p = t0[:, None] - 3 * d + j[None, :]  # [tiles, 2W]
    ok_p = (p >= 0) & (p < T)
    ch = 16 * torch.arange(nq)[:, None, None] + 8 * hh[None, :, None] + \
        torch.arange(8)[None, None, :]  # [nq, 2W, 8]
    ok = ok_p[:, None, :, None] & (ch < C)[None]
    vals = h_full[b[:, None, None, None], ch.clamp(max=C - 1)[None],
                  p.clamp(0, T - 1)[:, None, :, None]]
    vals = torch.where(ok, vals, torch.zeros(()))
    window = torch.full((B * ntt, nq, 2 * rows * 8), float("nan"))
    addr = ((hh * rows + j)[:, None] * 16 + 2 * torch.arange(8)) // 2
    window[:, :, addr] = vals  # [tiles, nq, 2W, 8] into the byte layout
    w7f, w1f = pack_resunit_weights(w7, w1, "default")
    a_ops = torch.stack([torch.stack([
        _gather(window, (64 * wg + k * d) * 16, 64, rows * 16, 128)
        for k in range(7)], 2) for wg in range(2)], 1)  # [tiles,2,nq,7,64,16]
    b_ops = torch.stack([_gather(w7f.flatten(1).float(), k * cp * 32, cp,
                                 cp * 16, 128) for k in range(7)], 1)
    v = torch.einsum("xwqktc,qkoc->xwto", a_ops.double(), b_ops.double())
    return {"a": a_ops, "b": b_ops, "v": v, "b_idx": b, "t0": t0,
            "w1f": w1f, "cp": cp, "nq": nq}


@pytest.mark.parametrize("T", [20, 1001, 4099])
@pytest.mark.parametrize("d", [1, 9])
@pytest.mark.parametrize("C", [8, 48, 96, 200])
def test_kernel_operand_addressing_reproduces_default_head(rng, C, d, T):
    """The kernel's operands, built and read with its own index formulas
    (``_emulate_operands``: the window's row offset k·d, the zero padding,
    channels ≥ C, the ragged last tile, tiles over the batch), hold exactly
    the plain version's rounded operands: h and w7 rebuilt from what the
    MMAs read give :func:`default_head` bit for bit through its own conv,
    and h2 and w1 read through the 1×1's descriptors give
    :func:`default_tail` bit for bit. Their float64 GEMMs agree with the
    plain convs' fp32 sums (1e-5 relative), h2 within one bf16 ulp."""
    B = 2 if T <= 1001 else 1
    p = _unit_params(rng, C)
    x = _bct(rng.standard_normal((B, T, C)).astype(np.float32))
    args = _port_args(p)
    w7, b7, a1, w1, b1, a2 = args
    for poly in (False, True):
        em = _emulate_operands(x, *args, d, poly)
        a_ops, cp, nq = em["a"], em["cp"], em["nq"]
        assert not torch.isnan(a_ops).any()  # rows past W are never read
        # h rebuilt from every tap's reads: t = t0 + 64 wg + r + (k - 3) d
        wg, k, r = torch.meshgrid(torch.arange(2), torch.arange(7),
                                  torch.arange(64), indexing="ij")
        t = em["t0"][:, None, None, None] + 64 * wg + r + (k - 3) * d
        # [tiles, 2, 7, 64]
        bb = em["b_idx"][:, None, None, None].expand_as(t)
        vals = a_ops.permute(0, 1, 3, 4, 2, 5).reshape(*t.shape, 16 * nq)
        inside = (t >= 0) & (t < T)
        assert not vals[~inside].any()  # the padding reads zeros
        assert not vals[..., C:].any()  # and so do channels >= C
        h_rec = torch.full((B, 16 * nq, T), float("nan"))
        h_rec[bb[inside], :, t[inside]] = vals[inside]
        # every read of one sample agrees with the others
        assert torch.equal(h_rec[bb[inside], :, t[inside]], vals[inside])
        assert not torch.isnan(h_rec).any()  # every sample was read
        w_rec = em["b"].permute(2, 0, 3, 1).reshape(cp, 16 * nq, 7)
        h2 = _head_from(h_rec[:, :C], w_rec[:C, :C], b7, a2, d, poly)
        want = default_head(x, w7, b7, a1, a2, d, poly)
        assert torch.equal(h2, want)
        # the k7's sums, in the kernel's tiles, against the plain fp32 conv
        with exact_fp32():
            v32 = torch.nn.functional.conv1d(
                _bf16(snake(x, a1, poly)), _bf16(w7), None, padding=3 * d,
                dilation=d)
        v = em["v"].reshape(B, -1, cp)[:, :T, :C].permute(0, 2, 1)
        scale = float(v32.abs().max())
        assert float((v - v32.double()).abs().max()) <= 1e-5 * scale
        # the 1x1: h2 staged per warpgroup, read chunk by chunk
        ntt = -(-T // 128)
        h2p = torch.zeros(B, cp, ntt * 128, dtype=torch.bfloat16)
        h2p[:, :C, :T] = want
        tiles = h2p.view(B, cp // 8, 8, ntt, 2, 64).permute(0, 3, 4, 1, 5, 2)
        buf = tiles.reshape(B, ntt, 2, -1)  # ((m // 8) * 64 + t) * 8 + m % 8
        a1x1 = torch.stack([_gather(buf, j * 2048, 64, 1024, 128)
                            for j in range(nq)], 3)  # [B, ntt, 2, nq, 64, 16]
        w1f = em["w1f"].flatten(1)
        b1x1 = torch.stack([_gather(w1f[j], 0, cp, cp * 16, 128)
                            for j in range(nq)])  # [nq, cp, 16]
        h2_rec = a1x1.permute(0, 3, 5, 1, 2, 4).reshape(B, 16 * nq, -1)
        w1_rec = b1x1.permute(1, 0, 2).reshape(cp, 16 * nq)[:C, :C, None]
        assert torch.equal(h2_rec[:, :C, :T], want)
        tail = default_tail(x, h2_rec[:, :C, :T], w1_rec.float(), b1)
        assert torch.equal(tail, default_tail(x, want, w1, b1))
        y = torch.einsum("bxwqtc,qoc->bxwto", a1x1.double(), b1x1.double())
        y = y.reshape(B, -1, cp)[:, :T, :C].permute(0, 2, 1)
        with exact_fp32():
            y32 = torch.nn.functional.conv1d(want.float(), _bf16(w1))
        assert float((y - y32.double()).abs().max()) <= 1e-5 * float(
            y32.abs().max())


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
