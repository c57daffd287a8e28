"""Port parity: the fused SEANet residual block's plain version and the
port's ``_apply_resnet`` against the JAX package's Pallas kernel (interpret
mode) and its XLA ``_apply_resnet`` (CPU, fp32, atol 2e-6). The packed
entry point against the JAX package's packed Pallas kernel in interpret
mode (atol 2e-5: that kernel's ELU is ``exp(x) - 1``, the port's
``expm1``).

The one-pass form (``precision="default"``): the plain version against a
float64 emulation of its rounding points; against the JAX package's kernel
at ``precision_name="default"`` in interpret mode on bf16-rounded inputs
(within 1e-2 · max|out|: JAX on the CPU runs DEFAULT f32 dots in full
f32, so the two differ at the bf16 scale), and against the same kernel with
its dots computed as the TPU computes DEFAULT (operands rounded to bf16)
within a few bf16 ulps; bf16 operands against the fp32 form on their
values, bit for bit; the tier's bf16-rounded biases; B3's entry in the
form; the form's packing layout (wgmma's K-major B operand) and the
one-pass kernel's operand addressing, emulated on the CPU.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocodecs_tpu.nn.layers import pad1d as j_pad1d
from audiocodecs_tpu.nn.seanet import SEANetConfig as JSEANetConfig
from audiocodecs_tpu.nn.seanet import _apply_resnet as j_apply_resnet
from audiocodecs_tpu.ops.seanet_block_packed import (
    seanet_resblock_packed as j_seanet_resblock_packed,
)
from audiocodecs_tpu.ops.seanet_block_pallas import seanet_resblock_pallas
from audiocodecs_tpu_torch.nn.layers import elu, exact_fp32, pad1d
from audiocodecs_tpu_torch.ops._build import CSRC
from audiocodecs_tpu_torch.nn.seanet import (
    ResBlock,
    SEANetConfig,
    _apply_resnet,
    _fused_eligible,
    _resnet_plain,
)
from audiocodecs_tpu_torch.ops.seanet_resblock import (
    _bf16,
    _layout,
    _mma_layout,
    default_errors,
    default_head,
    default_tail,
    operand_offsets,
    pack_resblock_weights,
    seanet_resblock_stages,
    seanet_resblock,
    seanet_resblock_packed,
    seanet_resblock_packed_reference,
    seanet_resblock_reference,
)

ATOL = 2e-6


def _jax_params(rng, C, H, shortcut=True):
    def c(k, i, o):
        return {"w": rng.standard_normal((k, i, o)).astype(np.float32) * 0.1,
                "b": rng.standard_normal(o).astype(np.float32) * 0.1}

    p = {"block": [c(3, C, H), c(1, H, C)]}
    if shortcut:
        p["shortcut"] = c(1, C, C)
    return p


def _port_block(p, C, cfg):
    blk = ResBlock(C, cfg)
    convs = [*blk.block] + ([blk.shortcut] if blk.shortcut is not None else [])
    src = [*p["block"]] + ([p["shortcut"]] if "shortcut" in p else [])
    with torch.no_grad():
        for conv, q in zip(convs, src):
            conv.w.copy_(torch.from_numpy(q["w"].transpose(2, 1, 0).copy()))
            conv.b.copy_(torch.from_numpy(q["b"]))
    return blk


def _kernel_args(x_bct, blk, pad_mode):
    halo = pad1d(x_bct[..., :3], 2, 0, mode=pad_mode)[..., :2].contiguous()
    c1, c2, s = blk.block[0], blk.block[1], blk.shortcut
    return (x_bct, halo, c1.w.detach(), c1.b.detach(), c2.w.detach(),
            c2.b.detach(), s.w.detach(), s.b.detach())


def _bct(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("T,tile", [(100, 32), (64, 64), (130, 64), (2, 32)])
def test_plain_block_matches_pallas_interpret(rng, pad_mode, T, tile):
    C, H = 32, 16
    p = _jax_params(rng, C, H)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    xp = j_pad1d(jnp.asarray(x), 2, 0, mode=pad_mode)
    want = seanet_resblock_pallas(
        xp, jnp.asarray(p["block"][0]["w"]), jnp.asarray(p["block"][0]["b"]),
        jnp.asarray(p["block"][1]["w"][0]), jnp.asarray(p["block"][1]["b"]),
        jnp.asarray(p["shortcut"]["w"][0]), jnp.asarray(p["shortcut"]["b"]),
        tile=tile, interpret=True)
    blk = _port_block(p, C, SEANetConfig(pad_mode=pad_mode))
    got = seanet_resblock_reference(*_kernel_args(_bct(x), blk, pad_mode))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("C,H,T", [(32, 16, 77), (64, 32, 40), (8, 4, 3),
                                   (16, 8, 1)])
def test_apply_resnet_matches_jax_xla_path(rng, pad_mode, C, H, T):
    """The port's dispatch (fused block's plain version on the CPU) against
    the reference's XLA form, including signals shorter than the halo."""
    p = _jax_params(rng, C, H)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    want = j_apply_resnet(jnp.asarray(x), p,
                          JSEANetConfig(causal=True, pad_mode=pad_mode), (1, 1))
    cfg = SEANetConfig(pad_mode=pad_mode)
    blk = _port_block(p, C, cfg)
    assert _fused_eligible(blk, cfg, (1, 1))
    with torch.no_grad():
        got = _apply_resnet(_bct(x), blk, cfg, (1, 1))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dilations,shortcut", [((2, 1), True),
                                                ((1, 1), False)])
def test_general_resnet_path_matches_jax(rng, dilations, shortcut):
    """Blocks the kernel does not cover take the general path."""
    C, H = 16, 8
    p = _jax_params(rng, C, H, shortcut=shortcut)
    x = rng.standard_normal((2, 50, C)).astype(np.float32)
    jcfg = JSEANetConfig(causal=True, pad_mode="reflect",
                         use_conv_shortcut=shortcut)
    want = j_apply_resnet(jnp.asarray(x), p, jcfg, dilations)
    cfg = SEANetConfig(use_conv_shortcut=shortcut)
    blk = _port_block(p, C, cfg)
    assert not _fused_eligible(blk, cfg, dilations)
    with torch.no_grad():
        got = _apply_resnet(_bct(x), blk, cfg, dilations)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=ATOL)


def test_wrapper_on_cpu_runs_plain_version_without_launching(rng):
    C, H = 32, 16
    cfg = SEANetConfig()
    blk = _port_block(_jax_params(rng, C, H), C, cfg)
    x = _bct(rng.standard_normal((2, 45, C)).astype(np.float32))
    args = _kernel_args(x, blk, "reflect")
    before = seanet_resblock.launches
    got = seanet_resblock(*args)
    assert seanet_resblock.launches == before
    torch.testing.assert_close(got, seanet_resblock_reference(*args),
                               rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(got, _resnet_plain(x, blk, cfg, (1, 1)),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("C,H", [(32, 16), (64, 32), (128, 64), (256, 128),
                                 (384, 192), (8, 4), (200, 100), (24, 30)])
def test_pack_layout_round_trips_with_zero_padding(rng, C, H):
    """Every tile of the kernel, and widths off its chunk and tile."""
    w1 = torch.from_numpy(rng.standard_normal((H, C, 3)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((C, H, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    before = pack_resblock_weights.packs
    w1p, w2p, wsp = pack_resblock_weights(w1, w2, ws)
    assert pack_resblock_weights.packs == before + 1
    Kp, Khp, M1p, Cp = _layout(C, H)
    assert (Kp, Khp) == (-(-C // 8) * 8, -(-H // 8) * 8)
    assert M1p >= H and Cp >= C
    assert tuple(w1p.shape) == (Kp, 3, M1p)
    assert tuple(w2p.shape) == (Khp, Cp) and tuple(wsp.shape) == (Kp, Cp)
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for t in (w1p, w2p, wsp))
    assert torch.equal(w1p[:C, :, :H].permute(2, 0, 1), w1)
    assert torch.equal(w2p[:H, :C].T[..., None], w2)
    assert torch.equal(wsp[:C, :C].T[..., None], ws)
    for t, (rows, cols) in ((w1p, (C, H)), (w2p, (H, C)), (wsp, (C, C))):
        pad = torch.ones_like(t, dtype=torch.bool)
        pad[:rows, ..., :cols] = False
        assert torch.count_nonzero(t[pad]) == 0


def test_wrapper_with_packed_weights_on_cpu_runs_plain_version(rng):
    C, H = 32, 16
    blk = _port_block(_jax_params(rng, C, H), C, SEANetConfig())
    x = _bct(rng.standard_normal((2, 45, C)).astype(np.float32))
    args = _kernel_args(x, blk, "reflect")
    packed = pack_resblock_weights(args[2], args[4], args[6])
    before = seanet_resblock.launches
    got = seanet_resblock(*args, packed=packed)
    assert seanet_resblock.launches == before
    torch.testing.assert_close(got, seanet_resblock_reference(*args),
                               rtol=0, atol=0)


def test_resblock_packs_once_per_weight_version(rng):
    """The cached layout is rebuilt only when a conv weight changes:
    ``load_state_dict`` writes in place and bumps the versions."""
    C, H = 32, 16
    cfg = SEANetConfig()
    blk = _port_block(_jax_params(rng, C, H), C, cfg)
    n0 = pack_resblock_weights.packs
    first = blk.packed_weights()
    assert blk.packed_weights() is first
    assert pack_resblock_weights.packs == n0 + 1
    assert set(blk.state_dict()) == {"block.0.w", "block.0.b", "block.1.w",
                                     "block.1.b", "shortcut.w", "shortcut.b"}
    other = _port_block(_jax_params(rng, C, H), C, cfg)
    blk.load_state_dict(other.state_dict())
    again = blk.packed_weights()
    assert pack_resblock_weights.packs == n0 + 2
    assert torch.equal(again[0], other.packed_weights()[0])
    assert not torch.equal(again[0], first[0])
    assert blk.packed_weights() is again
    # the CPU path of the model runs the plain version and packs nothing
    x = _bct(rng.standard_normal((1, 20, C)).astype(np.float32))
    n1 = pack_resblock_weights.packs
    with torch.no_grad():
        _apply_resnet(x, blk, cfg, (1, 1))
    assert pack_resblock_weights.packs == n1


def test_kernel_input_checks(rng):
    """What the kernel does not take raises before any launch."""
    from audiocodecs_tpu_torch.ops.seanet_resblock import _check

    C = 32
    blk = _port_block(_jax_params(rng, C, 16), C, SEANetConfig())
    x = _bct(rng.standard_normal((1, 20, C)).astype(np.float32))
    args = list(_kernel_args(x, blk, "reflect"))
    _check(*args)
    bad_halo = args[:1] + [args[1][..., :1]] + args[2:]
    with pytest.raises(ValueError):
        _check(*bad_halo)
    with pytest.raises(TypeError):
        _check(*[a.double() for a in args])
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2)] + args[1:]
    with pytest.raises(ValueError):
        _check(*strided)
    with pytest.raises(ValueError):
        seanet_resblock(*[a.to("meta") for a in args])
    packed = list(pack_resblock_weights(args[2], args[4], args[6]))
    _check(*args, packed)
    with pytest.raises(ValueError):
        _check(*args, [packed[0][:, :, :8]] + packed[1:])
    shifted = torch.zeros(packed[1].numel() + 1)[1:].view_as(packed[1])
    with pytest.raises(ValueError, match="aligned"):
        _check(*args, [packed[0], shifted, packed[2]])
    C = 512  # wider than the kernel's widest tile
    wide = [torch.zeros(s) for s in ((1, C, 4), (1, C, 2), (C // 2, C, 3),
                                     (C // 2,), (C, C // 2, 1), (C,),
                                     (C, C, 1), (C,))]
    with pytest.raises(ValueError, match="C <= 384"):
        _check(*wide)


def _packed_args(p):
    """The packed kernel's arguments: ``w1 [3, C, H]``, ``w2 [H, C]``,
    ``ws [C, C]``."""
    return (p["block"][0]["w"], p["block"][0]["b"], p["block"][1]["w"][0],
            p["block"][1]["b"], p["shortcut"]["w"][0], p["shortcut"]["b"])


@pytest.mark.parametrize("C,T,rows", [(32, 101, 8), (64, 63, 4),
                                      (32, 7, 512)])
def test_packed_entry_matches_jax_packed_kernel(rng, C, T, rows):
    """T is not a multiple of the TPU kernel's P = 128 // C samples a row."""
    H = C // 2
    p = _jax_params(rng, C, H)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    want = j_seanet_resblock_packed(
        jnp.asarray(x), *map(jnp.asarray, _packed_args(p)), tile_rows=rows,
        interpret=True)
    before = seanet_resblock_packed.launches
    got = seanet_resblock_packed(torch.from_numpy(x),
                                 *map(torch.from_numpy, _packed_args(p)))
    assert seanet_resblock_packed.launches == before
    assert tuple(got.shape) == (2, T, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the same block as the zero-pad XLA path
    want_xla = j_apply_resnet(jnp.asarray(x), p,
                              JSEANetConfig(causal=True, pad_mode="constant"),
                              (1, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)


def test_packed_entry_refuses_wide_blocks(rng):
    """C = 128 leaves one sample a lane row; both packages refuse it."""
    C, H = 128, 64
    p = _jax_params(rng, C, H)
    x = rng.standard_normal((1, 16, C)).astype(np.float32)
    with pytest.raises(ValueError, match="C <= 64"):
        j_seanet_resblock_packed(jnp.asarray(x),
                                 *map(jnp.asarray, _packed_args(p)),
                                 interpret=True)
    targs = [torch.from_numpy(x), *map(torch.from_numpy, _packed_args(p))]
    for fn in (seanet_resblock_packed, seanet_resblock_packed_reference):
        with pytest.raises(ValueError, match="C <= 64"):
            fn(*targs)



# ---- the one-pass form ---------------------------------------------------


def _np_bf16(a):
    """float64 values rounded to bf16 (nearest even), as float64."""
    return torch.from_numpy(np.asarray(a, np.float64)).float().to(
        torch.bfloat16).double().numpy()


def _np_elu(v):
    return np.where(v > 0, v, np.expm1(np.minimum(v, 0.0)))


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
                   - 7)


def _np_conv(h, w):
    """Valid conv of [B, C, T + K - 1] with w [O, C, K], float64."""
    K = w.shape[2]
    T = h.shape[2] - K + 1
    return sum(np.einsum("oc,bct->bot", w[:, :, k], h[:, :, k:k + T])
               for k in range(K))


def _block_args(p, x_btc, pad_mode="reflect", dtype=torch.float32):
    blk = _port_block(p, x_btc.shape[2], SEANetConfig(pad_mode=pad_mode))
    return [a.to(dtype) for a in _kernel_args(_bct(x_btc), blk, pad_mode)]


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("C,T", [(32, 300), (24, 7), (64, 2)])
def test_plain_default_form_matches_float64_emulation(rng, pad_mode, C, T):
    """The rounding points of the one bf16 pass, emulated in float64: h =
    bf16(ELU(x_pad)), the k3 conv of h and bf16(w1), + b1, h2 =
    bf16(ELU(·)), the 1×1 of h2 and bf16(w2), + b2, plus the shortcut of
    bf16(x) and bf16(ws), + bs. Each stage is emulated from the plain
    version's previous rounding point, so two correct roundings that
    straddle a boundary cost one ulp there and nothing downstream."""
    p = _jax_params(rng, C, C // 2)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    args = _block_args(p, x, pad_mode)
    tx, halo, w1, b1, w2, b2, ws, bs = args
    w1e, b1e, w2e, b2e, wse, bse = [a.double().numpy() for a in args[2:]]
    xp = torch.cat([halo, tx], -1).double().numpy()
    h_e = _np_bf16(_np_elu(xp))
    v_e = _np_conv(h_e, _np_bf16(w1e)) + b1e[None, :, None]
    h2_e = _np_bf16(_np_elu(v_e))
    h2 = default_head(tx, halo, w1, b1).double().numpy()
    assert (np.abs(h2 - h2_e) <= _bf16_ulp(h2_e)).all()
    assert (h2 != h2_e).mean() < 1e-3
    out = default_tail(tx, torch.from_numpy(h2).to(torch.bfloat16), w2, b2,
                       ws, bs).double().numpy()
    s_e = _np_conv(_np_bf16(tx.double().numpy()), _np_bf16(wse))
    out_e = (s_e + bse[None, :, None]) + (
        _np_conv(h2, _np_bf16(w2e)) + b2e[None, :, None])
    assert np.abs(out - out_e).max() <= 1e-5 * np.abs(out_e).max()
    full = seanet_resblock_reference(*args, precision="default")
    assert torch.equal(full, default_tail(
        tx, default_head(tx, halo, w1, b1), w2, b2, ws, bs))
    # one bf16 pass moves the block off the exact form, at the bf16 scale
    exact = seanet_resblock_reference(*args).numpy()
    dev = np.abs(full.numpy() - exact).max() / np.abs(exact).max()
    assert 1e-5 < dev < 1e-2


def _jax_default(p, x, pad_mode, one_pass=False, tile=32):
    """The JAX kernel at ``precision_name="default"`` in interpret mode on
    ``x`` [B, T, C]; with ``one_pass`` its dots as the TPU computes them."""
    import contextlib

    from seanet_tier import _OnePassDots
    from audiocodecs_tpu.ops import seanet_block_pallas as pallas

    xp = j_pad1d(jnp.asarray(x), 2, 0, mode=pad_mode)
    jnp_saved = pallas.jnp
    with contextlib.ExitStack() as stack:
        if one_pass:
            pallas.jnp = _OnePassDots(jnp_saved)
            stack.callback(setattr, pallas, "jnp", jnp_saved)
        kernel = pallas.seanet_resblock_pallas
        if one_pass:  # unjitted: a trace cached before the patch skips it
            kernel = kernel.__wrapped__
        out = kernel(
            xp, *map(jnp.asarray, (p["block"][0]["w"], p["block"][0]["b"],
                                   p["block"][1]["w"][0], p["block"][1]["b"],
                                   p["shortcut"]["w"][0], p["shortcut"]["b"])),
            tile=tile, interpret=True, precision_name="default")
        return np.asarray(out)


def _bf16_params(p):
    """The block's params rounded to bf16 (the tier's ``astype(bf16)``
    before the reference's cast back to f32), float32."""
    def r(a):
        return _np_bf16(a).astype(np.float32)

    return {k: [{n: r(a) for n, a in c.items()} for c in v]
            if isinstance(v, list) else {n: r(a) for n, a in v.items()}
            for k, v in p.items()}


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("C,T", [(32, 100), (64, 40)])
def test_plain_default_form_matches_jax_default_interpret(rng, pad_mode, C,
                                                          T):
    """On bf16-rounded inputs (the tier's block input and params), the port's
    one-pass plain version against the JAX kernel at precision "default":
    within 1e-2 · max|out| of JAX's CPU form (full f32 dots), and within a
    few bf16 ulps of the same kernel with the TPU's one-pass dots."""
    p = _bf16_params(_jax_params(rng, C, C // 2))
    x = _np_bf16(rng.standard_normal((2, T, C))).astype(np.float32)
    got = seanet_resblock_reference(*_block_args(p, x, pad_mode),
                                    precision="default").numpy()
    got = got.transpose(0, 2, 1)
    want = _jax_default(p, x, pad_mode)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-2 * scale
    assert np.abs(got - want).max() > 1e-6 * scale  # JAX's CPU form is f32
    tpu = _jax_default(p, x, pad_mode, one_pass=True)
    assert np.abs(got - tpu).max() <= 4 * _bf16_ulp(scale)
    assert np.sqrt(np.mean((got - tpu) ** 2)) <= 1e-2 * np.sqrt(
        np.mean((got - want) ** 2))


@pytest.mark.parametrize("C,T", [(32, 57), (16, 3)])
def test_default_form_on_bf16_is_the_fp32_form_rounded(rng, C, T):
    """bf16 operands: the fp32 form on their values, rounded once at the
    end, bit for bit (the reference's casts around its f32 kernel); the
    stages agree; bf16 with the exact form is refused."""
    p = _jax_params(rng, C, C // 2)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    args = _block_args(p, x, "reflect", torch.bfloat16)
    got = seanet_resblock(*args, precision="default")
    assert got.dtype == torch.bfloat16
    want = seanet_resblock_reference(*[a.float() for a in args],
                                     precision="default")
    assert torch.equal(got, want.to(torch.bfloat16))
    out, h2, k3 = seanet_resblock_stages(*args)
    assert torch.equal(out, got) and h2.dtype == torch.bfloat16
    assert default_errors(out, h2, k3, *args)["ok"]
    with pytest.raises(TypeError, match="precision='default'"):
        seanet_resblock(*args)
    with pytest.raises(ValueError, match="precision"):
        seanet_resblock(*args, precision="high")


def test_tier_biases_are_bf16_rounded(rng):
    """In the bf16 tier a fused block takes its params cast to bf16 (the
    reference's ``_cast_tree(params, bf16)`` before its f32 kernel), so the
    biases it adds are bf16-rounded values: the port's block in the tier's
    form equals the one-pass form on bf16-rounded biases, not on the fp32
    ones."""
    from audiocodecs_tpu_torch.nn.layers import DecodeForm

    C = 32
    p = _jax_params(rng, C, C // 2)
    for c in (*p["block"], p["shortcut"]):  # biases off the bf16 grid
        c["b"] = (c["b"] + 1e-3 / 3).astype(np.float32)
    x = _np_bf16(rng.standard_normal((2, 40, C))).astype(np.float32)
    cfg = SEANetConfig()
    blk = _port_block(p, C, cfg)
    form = DecodeForm(torch.bfloat16, "default")
    xb = _bct(x).to(torch.bfloat16)
    with torch.no_grad():
        got = _apply_resnet(xb, blk, cfg, (1, 1), form)
    args = _block_args(p, x)
    rounded = [a.to(torch.bfloat16).float() if i in (3, 5, 7) else a
               for i, a in enumerate(args)]
    want = seanet_resblock_reference(*rounded, precision="default")
    assert torch.equal(got, want.to(torch.bfloat16))
    unrounded = seanet_resblock_reference(*args, precision="default")
    assert not torch.equal(got, unrounded.to(torch.bfloat16))


@pytest.mark.parametrize("C,T", [(32, 101), (64, 9)])
def test_packed_entry_in_the_default_form(rng, C, T):
    """B3's entry in the one-pass form: the block's one-pass plain version
    on the converted layout with a zero halo, fp32 and bf16; against the
    JAX packed kernel at precision "default" at the bf16 scale."""
    p = _jax_params(rng, C, C // 2)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    targs = [torch.from_numpy(x), *map(torch.from_numpy, _packed_args(p))]
    before = dict(seanet_resblock_packed.launches_by_form)
    got = seanet_resblock_packed(*targs, precision="default")
    assert seanet_resblock_packed.launches_by_form == before
    assert torch.equal(got, seanet_resblock_packed_reference(
        *targs, precision="default"))
    want = _apply_resnet(_bct(x), _port_block(
        p, C, SEANetConfig(pad_mode="constant")), SEANetConfig(
            pad_mode="constant"), (1, 1), _default_form())
    assert torch.equal(got, want.transpose(1, 2))
    j = np.asarray(j_seanet_resblock_packed(
        jnp.asarray(x), *map(jnp.asarray, _packed_args(p)), interpret=True,
        precision_name="default"))
    assert np.abs(got.numpy() - j).max() <= 1e-2 * np.abs(j).max()
    bf = seanet_resblock_packed(*[t.to(torch.bfloat16) for t in targs],
                                precision="default")
    assert bf.dtype == torch.bfloat16 and bf.shape == (2, T, C)


def _default_form():
    from audiocodecs_tpu_torch.nn.layers import DecodeForm

    return DecodeForm(precision="default")


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


@pytest.mark.parametrize("rows,lbo,sbo", [(64, 72 * 16, 128),
                                           (64, 64 * 16, 128),
                                           (32, 32 * 16, 128),
                                           (16, 16 * 16, 128)])
def test_kernel_descriptor_is_the_wgmma_k_major_layout(rows, lbo, sbo):
    """wgmma's K-major operand without swizzle (PTX ISA: the matrix
    descriptor and the canonical layouts of shared-memory operands): 8-row
    x 16-byte core matrices of 128 contiguous bytes, SBO apart along M/N,
    LBO apart along K. The window (LBO = 72 · 16, its plane rows), the
    shortcut's operand and h2 (64 · 16), weight chunks at NP = 32 and 16. The
    kernel's descriptor encodes the ISA's fields: start >> 4 in bits 0-13,
    LBO >> 4 in 16-29, SBO >> 4 in 32-45, no swizzle; one unit added to the
    start field moves an operand with SBO = 128 on by one row, which is
    how tap k of the k3 conv reads the window at row offset k."""
    off = operand_offsets(rows, lbo, sbo)
    assert off.shape == (rows, 16)
    assert [off[0, 0], off[0, 7], off[1, 0], off[7, 7]] == [0, 14, 16, 126]
    assert sorted(off[:8, :8].flatten().tolist()) == list(range(0, 128, 2))
    assert off[8, 0] == sbo and off[0, 8] == lbo
    assert len(set(off.flatten().tolist())) == rows * 16
    make_desc = _kernel_make_desc()
    for start in (0, 16, 4096 + 48, 200000):
        desc = make_desc(start, lbo, sbo)
        assert desc & 0x3FFF == start >> 4
        assert (desc >> 16) & 0x3FFF == lbo >> 4
        assert (desc >> 32) & 0x3FFF == sbo >> 4
        assert desc >> 62 == 0
        for k in (1, 2):  # the k3 conv's taps
            assert make_desc(start + 16 * k, lbo, sbo) == desc + k
            if sbo == 128:
                longer = operand_offsets(rows + k, lbo, sbo)
                assert torch.equal(longer[k:], off + 16 * k)


@pytest.mark.parametrize("C,H", [(32, 16), (64, 32), (256, 128), (20, 10),
                                 (384, 192), (8, 30)])
def test_pack_default_is_the_wgmma_b_operand(rng, C, H):
    """``w1f[p, q, k, h, n, e] = bf16(w1[NP1 p + n, 16q + 8h + e, k])``,
    ``w2f[p, q, 0, h, n, e] = bf16(w2[NP2 p + n, 16q + 8h + e, 0])`` and
    ``wsf`` likewise, zero outside the matrix, in the instance's passes
    (csrc ``mma::pick``); each chunk's tap read through the kernel's
    descriptor (start k · NP · 32 bytes into the chunk, LBO = NP · 16,
    SBO = 128) is the [NP, 16] B operand; the three back to back fit the
    instance's resident weights."""
    w1 = torch.from_numpy(rng.standard_normal((H, C, 3)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((C, H, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    w1f, w2f, wsf = pack_resblock_weights(w1, w2, ws, "default")
    lay = _mma_layout(C, H)
    CP, HP, np1, np2 = lay["CP"], lay["HP"], lay["NP1"], lay["NP2"]
    assert C <= CP and H <= HP
    nq, nh = -(-C // 16), -(-H // 16)
    p1, p2 = -(-H // np1), -(-C // np2)
    assert w1f.shape == (p1, nq, 3, 2, np1, 8)
    assert w2f.shape == (p2, nh, 1, 2, np2, 8)
    assert wsf.shape == (p2, nq, 1, 2, np2, 8)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for t in (w1f, w2f, wsf))
    if lay["RES"]:
        assert 2 * (w1f.numel() + w2f.numel() + wsf.numel()) <= (
            8 * HP * CP + 2 * CP * CP)
    for f, w, np_, nk, taps in ((w1f, w1, np1, nq, 3), (w2f, w2, np2, nh, 1),
                                (wsf, ws, np2, nq, 1)):
        N, K = w.shape[:2]
        pad = torch.zeros(f.shape[0] * np_, 16 * nk, taps)
        pad[:N, :K] = w.to(torch.bfloat16).float()
        idx = operand_offsets(np_, np_ * 16, 128) // 2
        flat = f.float().flatten()
        chunk = taps * np_ * 16  # elements a chunk
        for p in range(f.shape[0]):
            for q in range(nk):
                for k in range(taps):
                    got = flat[(p * nk + q) * chunk + k * np_ * 16 + idx]
                    want = pad[p * np_:(p + 1) * np_, 16 * q:16 * q + 16, k]
                    assert torch.equal(got, want)


def _acc_cells(n):
    """Row and column of each accumulator of wgmma m64nNk16 (the kernel's
    comment at ``Wgmma``): thread 32 w + l, register i at row 16 w + l // 4
    + 8 ((i // 2) % 2), column 8 (i // 4) + 2 (l % 4) + i % 2, as two
    [128, n / 2] tensors."""
    wt = torch.arange(128)[:, None]
    i = torch.arange(n // 2)[None, :]
    w, lane = wt // 32, wt % 32
    row = 16 * w + lane // 4 + 8 * ((i // 2) % 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return row.expand(128, n // 2), col.expand(128, n // 2)


def _staged(vals, esize):
    """The output staging of one pass (csrc ``consumer_role``): the
    accumulators ``vals [64, N]`` written at ol · 64 + (t ^ 8 ((ol // 2) %
    4)), then read by the store loop, thread i a vector of V = 16 / esize
    samples of channel i // (64 / V) (bf16: its two halves in the order
    the kernel reads them). Returns what the stores write, [N, 64]."""
    n = vals.shape[1]
    row, col = _acc_cells(n)
    ost = torch.full((n * 64,), float("nan"), dtype=torch.float64)
    ost[col * 64 + (row ^ (8 * ((col // 2) % 4)))] = vals[row, col]
    v = 16 // esize
    per = 64 // v
    out = torch.full((n, 64), float("nan"), dtype=torch.float64)
    for i in range(n * per):
        ol, tv = i // per, (i % per) * v
        src = ol * 64 + (tv ^ (8 * ((ol // 2) % 4)))
        first = ((tv >> 5) & 1) * 4
        halves = [0] if v == 4 else [first, 4 - first]
        for h in halves:
            out[ol, tv + h:tv + h + 4] = ost[src + h:src + h + 4]
    return out


def _block_walk(nitems, grid):
    """Items in the order the persistent blocks walk them (csrc
    ``block_items``, ``item_at``): block k takes k, k + grid, ..."""
    walk = []
    for blk in range(grid):
        my = (nitems - 1 - blk) // grid + 1 if blk < nitems else 0
        walk += [blk + n * grid for n in range(my)]
    return walk


def _emulate_one_pass(x, halo, w1, w2, ws, grid):
    """The one-pass kernel's operands as it addresses them (csrc
    ``seanet_resblock.cu``, namespace ``mma``), in torch on the CPU, for
    each item of the blocks' walk (``_block_walk``):

    * the raw tiles that TMA loads, RC channels (the instance's) from r · RC
      x 72 samples from t0 - 8, zero outside [0, T) and past C (and, where
      the rows are not 16-byte aligned, x read straight: the same values);
    * the transform warps' writes: main unit e of raw tile r is channels
      c0 = r · RC + 8 (e // 32) at window rows 2 + jj and 34 + jj (jj =
      e % 32, positions t0 + jj and t0 + 32 + jj): bf16(ELU(v)) at
      element ((c0 // 8) · 72 + row) · 8 + i of the window and bf16(v)
      at ((c0 // 8) · 64 + row - 2) · 8 + i of the shortcut's operand;
      the two halo rows j = 0, 1 one element a thread, channel c = r · RC
      + e % RC, j = e // RC, at ((c // 8) · 72 + j) · 8 + c % 8, from
      halo [B, C, 2] at t0 = 0; every other element NaN, so a read of one
      shows;
    * the descriptors' reads: the k3 conv's A of chunk q, tap k at start
      (q · 2 · 72 + k) · 16 (LBO 72 · 16, SBO 128), its B at chunk (p, q),
      tap k of w1f (LBO NP1 · 16); the shortcut's A at q · 2 · 64 · 16
      (LBO 64 · 16) with wsf's chunk (p, q).

    Returns the A and B reads by item, and the GEMMs' float64 sums."""
    B, C, T = x.shape
    Hc = w1.shape[0]
    lay = _mma_layout(C, Hc)
    cp, np1, np2, rc = lay["CP"], lay["NP1"], lay["NP2"], lay["RC"]
    nq, nr = -(-C // 16), -(-C // rc)
    ntt = -(-T // 64)
    walk = _block_walk(B * ntt, grid)
    assert sorted(walk) == list(range(B * ntt))  # each item once
    h = _bf16(elu(x))
    e = torch.arange(rc // 8 * 32)
    g8, jj = e // 32, e % 32
    eh = torch.arange(2 * rc)
    w1f, w2f, wsf = pack_resblock_weights(w1, w2, ws, "default")
    off_a = operand_offsets(64, 72 * 16, 128)
    off_s = operand_offsets(64, 64 * 16, 128)
    b1_ops = torch.stack([torch.stack([torch.stack([
        w1f.float().flatten()[((p * nq + q) * 3 * np1 * 16 + k * np1 * 16)
                              + operand_offsets(np1, np1 * 16, 128) // 2]
        for k in range(3)]) for q in range(nq)]) for p in range(
            w1f.shape[0])])  # [p1, nq, 3, NP1, 16]
    bs_ops = torch.stack([torch.stack([
        wsf.float().flatten()[(p * nq + q) * np2 * 16
                              + operand_offsets(np2, np2 * 16, 128) // 2]
        for q in range(nq)])
        for p in range(wsf.shape[0])])  # [p2, nq, NP2, 16]
    items = []
    for it in walk:
        b, t0 = it // ntt, (it % ntt) * 64
        win = torch.full((72 * cp,), float("nan"))
        sc = torch.full((64 * cp,), float("nan"))
        for r in range(nr):
            c = r * rc + torch.arange(rc)[:, None]
            p = t0 - 8 + torch.arange(72)[None, :]
            ok = (c < C) & (p >= 0) & (p < T)
            raw = torch.where(ok, x[b, c.clamp(max=C - 1), p.clamp(0, T - 1)],
                              torch.zeros(()))
            c0 = r * rc + 8 * g8
            cc = c0[:, None] + torch.arange(8)[None, :]  # [units, 8]
            for half in (0, 32):  # rows 2 + jj + half
                pos = (t0 + jj + half)[:, None]
                v = raw[8 * g8[:, None] + torch.arange(8), (8 + jj + half)[
                    :, None]]
                direct = torch.where((cc < C) & (pos < T), x[
                    b, cc.clamp(max=C - 1), pos.clamp(max=T - 1)],
                    torch.zeros(()))
                assert torch.equal(v, direct)  # TMA and direct loads agree
                row = (2 + jj + half)[:, None]
                win[((c0[:, None] // 8) * 72 + row) * 8
                    + torch.arange(8)] = _bf16(elu(v))
                sc[((c0[:, None] // 8) * 64 + row - 2) * 8
                   + torch.arange(8)] = _bf16(v)
            cl, j = eh % rc, eh // rc
            c = r * rc + cl
            p = t0 - 2 + j
            live = c < C
            v = torch.where(~live, torch.zeros(()), torch.where(
                p < 0, halo[b, c.clamp(max=C - 1), (p + 2).clamp(0, 1)],
                raw[cl, 6 + j]))
            direct = torch.where(~live | (p >= T), torch.zeros(()),
                                 torch.where(p < 0, halo[
                                     b, c.clamp(max=C - 1),
                                     (p + 2).clamp(0, 1)], x[
                                     b, c.clamp(max=C - 1),
                                     p.clamp(0, T - 1)]))
            assert torch.equal(v, direct)
            win[((c // 8) * 72 + j) * 8 + c % 8] = _bf16(elu(v))
        a_ops = torch.stack([torch.stack([
            win[(q * 2 * 72 * 16 + k * 16 + off_a) // 2] for k in range(3)])
            for q in range(nq)])  # [nq, 3, 64, 16]
        s_ops = torch.stack([sc[(q * 2 * 64 * 16 + off_s) // 2]
                             for q in range(nq)])  # [nq, 64, 16]
        items.append({"b": b, "t0": t0, "a": a_ops, "s": s_ops})
    return {"items": items, "w1": b1_ops, "ws": bs_ops, "w2f": w2f,
            "h": h, "lay": lay, "nq": nq}


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of many small tensor ops: with
    several pytest workers on the machine's cores, torch's thread pool
    makes each op wait (25 s against 0.15 s for the C = 384 case)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("T,grid", [(150, 4), (61, 5)])
@pytest.mark.parametrize("C", [8, 32, 40, 256, 384])
def test_kernel_operand_addressing_reproduces_default_head_and_tail(
        rng, one_thread, C, T, grid):
    """The one-pass kernel's operands, built and read with its own index
    formulas (``_emulate_one_pass``: the raw tiles, the window's row
    offset k, the halo, zero padding past T and C, items walked by
    persistent blocks, here 6 items over 4 blocks and 2 over 5), hold
    exactly the plain version's rounded operands: h and w1 rebuilt from
    what the k3 conv's MMAs read give :func:`default_head` bit for bit
    through its own conv; bf16(x), ws, h2 (staged as the epilogue writes
    it) and w2 read through the second GEMM's descriptors give
    :func:`default_tail` bit for bit. The float64 GEMMs in the kernel's
    tiles agree with the plain convs' fp32 sums (1e-5 relative), and the
    output staging hands each channel row's samples to the stores in
    order."""
    B, Hc = 2, C // 2
    p = _jax_params(rng, C, Hc)
    x = _bct(rng.standard_normal((B, T, C)).astype(np.float32))
    args = _block_args(p, x.transpose(1, 2).numpy())
    x, halo, w1, b1, w2, b2, ws, bs = args
    em = _emulate_one_pass(x, halo, w1, w2, ws, grid)
    lay, nq = em["lay"], em["nq"]
    np1, np2 = lay["NP1"], lay["NP2"]
    hpad = torch.full((B, 16 * nq, T + 2), float("nan"))
    spad = torch.full((B, 16 * nq, T), float("nan"))
    k3 = torch.zeros(B, w1.shape[0], T, dtype=torch.float64)
    for item in em["items"]:
        b, t0, a_ops, s_ops = item["b"], item["t0"], item["a"], item["s"]
        assert not torch.isnan(a_ops).any() and not torch.isnan(s_ops).any()
        n = min(64, T - t0)
        for k in range(3):
            # tap k's row t is position t0 + t + k - 2 (padded index + 2)
            vals = a_ops[:, k, :, :].permute(0, 2, 1).reshape(16 * nq, 64)
            cols = t0 + torch.arange(64) + k
            inside = cols < T + 2
            assert not vals[:, ~inside].any()  # past T reads zeros
            seen = hpad[b][:, cols[inside]]
            known = ~torch.isnan(seen)
            assert torch.equal(seen[known], vals[:, inside][known])
            hpad[b][:, cols[inside]] = vals[:, inside]
        svals = s_ops.permute(0, 2, 1).reshape(16 * nq, 64)
        assert not svals[:, n:].any()
        spad[b][:, t0:t0 + n] = svals[:, :n]
        acc = torch.einsum("qktc,pqknc->tpn", a_ops.double(),
                           em["w1"].double()).reshape(64, -1)
        k3[b, :, t0:t0 + n] = acc[:n, :w1.shape[0]].T
    assert not torch.isnan(hpad).any() and not torch.isnan(spad).any()
    assert not hpad[:, C:].any() and not spad[:, C:].any()
    w1_rec = em["w1"].permute(0, 3, 1, 4, 2).reshape(
        -1, 16 * nq, 3)[:w1.shape[0], :C]
    assert torch.equal(w1_rec, _bf16(w1))
    h_in = hpad[:, :C]
    assert torch.equal(h_in, _bf16(elu(torch.cat([halo, x], -1))))
    with exact_fp32():
        v32 = torch.nn.functional.conv1d(h_in, w1_rec) + b1[:, None]
    h2 = elu(v32).to(torch.bfloat16)
    want = default_head(x, halo, w1, b1)
    assert torch.equal(h2, want)
    scale = float((v32 - b1[:, None]).abs().max())
    assert float((k3 - (v32 - b1[:, None]).double()).abs().max()) <= (
        1e-5 * scale)
    # the second GEMM: h2 staged as the k3 epilogue writes it, read by the
    # 1x1's descriptors; bf16(x) and ws through the shortcut's
    assert torch.equal(spad[:, :C], _bf16(x))
    nh = -(-Hc // 16)
    w2f = em["w2f"].float().flatten()
    off2 = operand_offsets(np2, np2 * 16, 128) // 2
    w2_rec = torch.stack([torch.stack([
        w2f[(pp * nh + q) * np2 * 16 + off2] for q in range(nh)])
        for pp in range(em["w2f"].shape[0])])  # [p2, nh, NP2, 16]
    w2_rec = w2_rec.permute(0, 2, 1, 3).reshape(-1, 16 * nh)[:C, :Hc]
    ws_rec = em["ws"].permute(0, 2, 1, 3).reshape(-1, 16 * nq)[:C, :C]
    assert torch.equal(w2_rec, _bf16(w2[:, :, 0]))
    assert torch.equal(ws_rec, _bf16(ws[:, :, 0]))
    for n in (np1, np2):  # the accumulators cover the m64 x N tile once
        row, col = _acc_cells(n)
        assert len(set(zip(row.flatten().tolist(),
                           col.flatten().tolist()))) == 64 * n
    w2_ops = torch.stack([torch.stack([
        w2f[(pp * nh + q) * np2 * 16 + off2] for q in range(nh)])
        for pp in range(em["w2f"].shape[0])])  # [p2, nh, NP2, 16]
    tail_want = default_tail(x, want, w2, b2, ws, bs)
    h2_rec = torch.zeros(B, 16 * nh, T)
    m = torch.arange(16 * nh)[:, None]
    t = torch.arange(64)[None, :]
    for item in em["items"]:
        b, t0 = item["b"], item["t0"]
        n = min(64, T - t0)
        # h2 written by the k3 epilogue at ((m // 8) * 64 + t) * 8 + m % 8
        h2s = torch.full((16 * nh * 64,), float("nan"))
        vals = torch.zeros(16 * nh, 64)
        vals[:Hc, :n] = want[b, :, t0:t0 + n].float()
        h2s[((m // 8) * 64 + t) * 8 + m % 8] = vals
        a2 = torch.stack([h2s[(q * 2 * 64 * 16 + operand_offsets(
            64, 64 * 16, 128)) // 2] for q in range(nh)])  # [nh, 64, 16]
        assert not torch.isnan(a2).any()
        h2_rec[b, :, t0:t0 + n] = a2.permute(0, 2, 1).reshape(
            16 * nh, 64)[:, :n]
    # a pass's sums through the output staging hand each channel row's
    # samples to the stores in order, for both dtypes
    block = torch.from_numpy(rng.standard_normal((64, np2)))
    for esize in (4, 2):
        assert torch.equal(_staged(block, esize), block.T)
    assert torch.equal(h2_rec[:, :Hc], want.float())
    tail = default_tail(spad[:, :C], h2_rec[:, :Hc].to(torch.bfloat16),
                        w2_rec[..., None], b2, ws_rec[..., None], bs)
    assert torch.equal(tail, tail_want)


def test_resblock_packs_once_per_form(rng):
    """The block's cached layout follows its precision: the one-pass
    layout is built once, and again only when the form or a weight
    changes."""
    C = 32
    blk = _port_block(_jax_params(rng, C, 16), C, SEANetConfig())
    n0 = pack_resblock_weights.packs
    one = blk.packed_weights("default")
    assert blk.packed_weights("default") is one
    assert one[0].dtype == torch.bfloat16
    exact = blk.packed_weights()
    assert exact[0].dtype == torch.float32
    assert pack_resblock_weights.packs == n0 + 2


def test_default_form_gradient_recomputes_the_one_pass_form(rng):
    """The Function's backward recomputes through the plain version in the
    same form: the gradient equals the one-pass plain version's own."""
    C = 8
    args = [a.requires_grad_() for a in _block_args(
        _jax_params(rng, C, 4), rng.standard_normal((2, 9, C)).astype(
            np.float32))]
    g = torch.from_numpy(rng.standard_normal((2, C, 9)).astype(np.float32))
    got = torch.autograd.grad((seanet_resblock(*args, precision="default")
                               * g).sum(), args)
    want = torch.autograd.grad((seanet_resblock_reference(
        *args, precision="default") * g).sum(), args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
