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
form; the form's packing layout (mma.m16n8k16's B fragments).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

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
from audiocodecs_tpu_torch.nn.layers import pad1d
from audiocodecs_tpu_torch.nn.seanet import (
    ResBlock,
    SEANetConfig,
    _apply_resnet,
    _fused_eligible,
    _resnet_plain,
)
from audiocodecs_tpu_torch.ops.seanet_resblock import (
    _b_fragment_index,
    _layout,
    default_errors,
    default_head,
    default_tail,
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


def test_b_fragment_index_is_the_ptx_b_layout():
    """mma.m16n8k16's B fragment (PTX ISA): lane l = 4g + t holds rows 2t,
    2t + 1, 2t + 8, 2t + 9 of column g of the 16 × 8 tile."""
    rows, cols = _b_fragment_index()
    assert rows[0].tolist() == [0, 1, 8, 9]
    assert rows[5].tolist() == [2, 3, 10, 11] and cols[5].tolist() == [1] * 4
    cells = {(r, c) for r, c in zip(rows.flatten().tolist(),
                                    cols.flatten().tolist())}
    assert len(cells) == 128  # every cell of the tile once


@pytest.mark.parametrize("C,H", [(32, 16), (64, 32), (256, 128), (20, 10),
                                 (384, 192), (8, 30)])
def test_pack_default_layout(rng, C, H):
    """``w1f[k, q, t, l, e] = bf16(w1[8t + n, 16q + r, k])``, ``w2f[q, t, l,
    e] = bf16(w2[8t + n, 16q + r, 0])`` and ``wsf`` likewise, with (r, n)
    the fragment cell of (l, e); zero outside the matrix."""
    w1 = torch.from_numpy(rng.standard_normal((H, C, 3)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((C, H, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((C, C, 1)).astype(np.float32))
    w1f, w2f, wsf = pack_resblock_weights(w1, w2, ws, "default")
    nq, nh, t1, t2 = -(-C // 16), -(-H // 16), -(-H // 8), -(-C // 8)
    assert w1f.shape == (3, nq, t1, 32, 4) and w2f.shape == (nh, t2, 32, 4)
    assert wsf.shape == (nq, t2, 32, 4)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for t in (w1f, w2f, wsf))
    rows, cols = _b_fragment_index()

    def unpack(f, K, N):
        m = torch.zeros(f.shape[-4] * 16, f.shape[-3] * 8)
        for q in range(f.shape[-4]):
            for t in range(f.shape[-3]):
                m[16 * q + rows, 8 * t + cols] = f[q, t].float()
        assert not m[K:].any() and not m[:, N:].any()
        return m[:K, :N]

    for k in range(3):
        assert torch.equal(unpack(w1f[k], C, H),
                           w1[:, :, k].T.to(torch.bfloat16).float())
    assert torch.equal(unpack(w2f, H, C),
                       w2[:, :, 0].T.to(torch.bfloat16).float())
    assert torch.equal(unpack(wsf, C, C),
                       ws[:, :, 0].T.to(torch.bfloat16).float())


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
