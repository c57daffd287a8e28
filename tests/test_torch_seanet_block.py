"""Port parity: the fused SEANet residual block's plain version and the
port's ``_apply_resnet`` against the JAX package's Pallas kernel (interpret
mode) and its XLA ``_apply_resnet`` (CPU, fp32, atol 2e-6). The packed
entry point against the JAX package's packed Pallas kernel in interpret
mode (atol 2e-5: that kernel's ELU is ``exp(x) - 1``, the port's
``expm1``).

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
    _layout,
    pack_resblock_weights,
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
