"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (``nvcc``) and
skips without them. The file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: kernel against plain version 1e-5 (absolute for the LSTM,
relative to max(1, max|ref|) for the blocks and the DAC unit's exact
forms), the limits ``chip_smoke.py`` uses; the DAC unit's and the SEANet
block's default form (one bf16 pass) one rounding point at a time
(``ops/dac_resunit.py::default_errors``,
``ops/seanet_resblock.py::default_errors``). A Function's gradient (kernel
forward, backward recomputed through the plain version) against autograd
through the plain version: 1e-4 of the plain gradient's max|g| (cuDNN may pick another
backward algorithm for the two, in another summation order).
"""

import numpy as np
import pytest
import torch

from audiocodecs_tpu_torch.models.dac import DAC, DACModelConfig
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.models.mimi import Mimi, MimiModelConfig
from audiocodecs_tpu_torch.models.past import PAST
from audiocodecs_tpu_torch.models.seanet_rvq import SEANetRVQConfig
from audiocodecs_tpu_torch.models.speechtokenizer import (
    SpeechTokenizer,
    SpeechTokenizerModelConfig,
)
from audiocodecs_tpu_torch.models.wavtokenizer import (
    WavTokenizer,
    WavTokenizerModelConfig,
)
from audiocodecs_tpu_torch.nn.layers import exact_fp32, pad1d
from audiocodecs_tpu_torch.nn.lstm import (
    bilstm,
    init_bilstm_params,
    init_lstm_params,
    lstm,
)
from audiocodecs_tpu_torch.nn.vocos import VocosConfig, istft
from audiocodecs_tpu_torch.ops.lstm_recurrence import (
    handoff_us,
    lstm_recurrence,
    lstm_recurrence_info,
    lstm_recurrence_reference,
)
from audiocodecs_tpu_torch.ops.dac_resunit import (
    _smem_bytes,
    dac_resunit,
    dac_resunit_info,
    dac_resunit_reference,
    dac_resunit_stages,
    default_errors,
    form_name,
    pack_resunit_weights,
)
from audiocodecs_tpu_torch.ops.seanet_resblock import (
    _mma_layout as _resblock_mma_layout,
    _smem_bytes as _resblock_smem_bytes,
    default_errors as resblock_default_errors,
    pack_resblock_weights,
    seanet_resblock,
    seanet_resblock_stages,
    seanet_resblock_elu_check,
    seanet_resblock_info,
    seanet_resblock_packed,
    seanet_resblock_packed_reference,
    seanet_resblock_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _dac_launches() -> int:
    """The DAC unit's kernel launches in this process, every form."""
    return sum(dac_resunit.launches_by_form.values())


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


@pytest.mark.parametrize("T,B,H", [(257, 3, 512), (20, 200, 512),
                                   (33, 4, 32), (9, 2, 1024)])
def test_lstm_kernel_matches_plain_version(dev, T, B, H):
    """B=200 at H=512 is more rows than one launch holds: the wrapper
    splits it into two launches."""
    rng = np.random.default_rng(T + B + H)
    args = [_t(rng.standard_normal((T, B, 4 * H)), dev),
            _t(rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H), dev),
            _t(rng.standard_normal((B, H)) * 0.5, dev),
            _t(rng.standard_normal((B, H)) * 0.5, dev)]
    before = lstm_recurrence.launches
    with torch.inference_mode(), exact_fp32():
        got = lstm_recurrence(*args)
        want = lstm_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches > before
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5


def _lstm_args(rng, T, B, H, dev):
    return [_t(rng.standard_normal((T, B, 4 * H)), dev),
            _t(rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H), dev),
            _t(rng.standard_normal((B, H)) * 0.5, dev),
            _t(rng.standard_normal((B, H)) * 0.5, dev)]


def _lstm_close(got, want):
    return all(float((g - w).abs().max()) <= 1e-5 for g, w in zip(got, want))


@pytest.mark.parametrize("H", [32, 512, 1024])
def test_lstm_one_step_from_a_nonzero_state(dev, H):
    """T = 1, the ``lstm_cell_step`` path: no exchange at all."""
    args = _lstm_args(np.random.default_rng(H), 1, 5, H, dev)
    with torch.inference_mode(), exact_fp32():
        got = lstm_recurrence(*args)
        want = lstm_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert float(args[2].abs().max()) > 0 and float(args[3].abs().max()) > 0
    assert _lstm_close(got, want)


def test_lstm_batch_split_over_two_launches(dev):
    H = 512
    rows = lstm_recurrence_info(H, 1)["max_batch"]
    args = _lstm_args(np.random.default_rng(0), 7, rows + 1, H, dev)
    before = lstm_recurrence.launches
    with torch.inference_mode(), exact_fp32():
        got = lstm_recurrence(*args)
        want = lstm_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 2
    assert _lstm_close(got, want)


@pytest.mark.parametrize("shapes", [[(2, 8, 512), (2, 8, 512)],
                                    [(40, 8, 512), (40, 8, 512)],
                                    [(30, 8, 512), (30, 3, 512)],
                                    [(5, 16, 256), (30, 2, 256)],
                                    [(1, 8, 512), (2, 8, 512)]])
def test_lstm_back_to_back_launches_see_no_stale_exchange(dev, shapes):
    """Launches queued one after the other on one stream reuse the
    exchange's memory (the caching allocator hands the freed block back).
    At T = 2 the first launch leaves the very tag the second waits for; a
    launch after one of another B finds pairs at other offsets."""
    rng = np.random.default_rng(sum(shapes[0]) + shapes[1][1])
    runs = [_lstm_args(rng, T, B, H, dev) for T, B, H in shapes]
    with torch.inference_mode(), exact_fp32():
        got = [lstm_recurrence(*a) for a in runs]
        want = [lstm_recurrence_reference(*a) for a in runs]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _lstm_close(g, w)


@pytest.mark.parametrize("H", [32, 512, 1024])
def test_lstm_kernel_info(dev, H):
    """Units a block by the rule, no spills, one block an SM fits, and
    every launch shape up to ``max_batch`` rows fits the card."""
    info = lstm_recurrence_info(H, 8)
    assert info["units"] in (1, 2, 4, 8) and H // info["units"] <= 132
    assert 0 < info["regs"] <= 255
    assert info["local_bytes"] == 0
    assert info["blocks_per_sm"] >= 1
    assert info["max_batch"] >= 8
    assert lstm_recurrence_info(H, info["max_batch"])["blocks_per_sm"] >= 1


@pytest.mark.parametrize("T,B,H", [(60, 8, 1536), (40, 1, 1536),
                                   (33, 3, 1536), (9, 20, 1536),
                                   (1, 5, 1536), (25, 4, 1088),
                                   (12, 2, 1056)])
def test_lstm_wide_kernel_matches_plain_version(dev, T, B, H):
    """The wide instance (1024 < H <= 1536): B = 8 and 1 (its two row
    counts), ragged B, 20 rows over three launches of at most 8, one step,
    and widths off its 12 units a block (1088: the last block has spare
    warps)."""
    args = _lstm_args(np.random.default_rng(T * B + H), T, B, H, dev)
    rows = lstm_recurrence_info(H, 1)["max_batch"]
    before = lstm_recurrence.launches
    with torch.inference_mode(), exact_fp32():
        got = lstm_recurrence(*args)
        want = lstm_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert rows == 8
    assert lstm_recurrence.launches == before + -(-B // rows)
    assert _lstm_close(got, want)


def test_lstm_wide_kernel_info(dev):
    """12 units a block, no spills, one block an SM, 8 rows a launch."""
    for B in (1, 8):
        info = lstm_recurrence_info(1536, B)
        assert info["units"] == 12 and info["max_batch"] == 8
        assert info["local_bytes"] == 0 and 0 < info["regs"] <= 168
        assert info["blocks_per_sm"] == 1
        assert info["smem_bytes"] <= 232448


def test_lstm_handoff_probe(dev):
    us = handoff_us(2000)
    assert 0.0 < us < 10.0


@pytest.mark.parametrize("B,C,T,pad_mode", [
    (2, 32, 1001, "reflect"), (2, 256, 300, "reflect"), (1, 8, 2, "reflect"),
    (2, 64, 129, "constant"), (2, 32, 1024, "reflect"),
    (2, 64, 1001, "reflect"), (2, 128, 1001, "constant"),
    (2, 256, 1024, "constant"), (2, 384, 1001, "reflect"),
    (1, 384, 64, "constant"), (1, 32, 1, "reflect"), (1, 32, 1, "constant"),
    (1, 128, 2, "reflect"), (1, 256, 2, "constant"), (3, 16, 77, "reflect"),
    (1, 200, 333, "reflect")])
def test_resblock_kernel_matches_plain_version(dev, B, C, T, pad_mode):
    """Every tile of the kernel (C = 32, 64, 128, 256, 384), widths off
    them, ragged and unaligned T (rows not 16-byte aligned), T = 1 and 2,
    B = 1; with the weights packed by the caller and by the wrapper."""
    rng = np.random.default_rng(B + C + T)
    Hc = C // 2
    x = _t(rng.standard_normal((B, C, T)), dev)
    halo = pad1d(x[..., :3], 2, 0, mode=pad_mode)[..., :2].contiguous()
    weights = [_t(rng.standard_normal(s) / np.sqrt(f), dev) for s, f in (
        ((Hc, C, 3), 3 * C), ((Hc,), 3 * C), ((C, Hc, 1), Hc), ((C,), Hc),
        ((C, C, 1), C), ((C,), C))]
    before = seanet_resblock.launches
    with torch.inference_mode():
        packed = pack_resblock_weights(weights[0], weights[2], weights[4])
        got = seanet_resblock(x, halo, *weights, packed=packed)
        got_unpacked = seanet_resblock(x, halo, *weights)
        want = seanet_resblock_reference(x, halo, *weights)
    torch.cuda.synchronize()
    assert seanet_resblock.launches == before + 2
    assert float((got - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    assert torch.equal(got, got_unpacked)


@pytest.mark.parametrize("C", [32, 64, 128, 256, 384])
def test_resblock_kernel_info(dev, C):
    """Registers, spills, shared bytes and blocks an SM of the tile the
    wrapper launches: no spills, and the wrapper's shared-memory count."""
    info = seanet_resblock_info(C, C // 2)
    assert info["local_bytes"] == 0
    assert info["smem_bytes"] == _resblock_smem_bytes(C, C // 2)
    assert 0 < info["regs"] <= 255
    assert info["blocks_per_sm"] >= 1 and info["tile"] % 64 == 0


@pytest.mark.parametrize("H", [48, 1568])
def test_lstm_on_the_card_refuses_widths_the_kernel_does_not_take(dev, H):
    """No plain loop on the card: the kernel takes H % 32 == 0, H <= 1536."""
    params = [{k: v.to(dev) for k, v in p.items()} for p in
              init_lstm_params(torch.Generator().manual_seed(0), 1, 8, H)]
    before = lstm_recurrence.launches
    with pytest.raises(ValueError, match="H % 32 == 0"):
        lstm(torch.zeros(1, 3, 8, device=dev), params)
    assert lstm_recurrence.launches == before


def test_resblock_on_the_card_refuses_widths_the_kernel_does_not_take(dev):
    C = 512
    args = [torch.zeros(s, device=dev) for s in (
        (1, C, 4), (1, C, 2), (C // 2, C, 3), (C // 2,), (C, C // 2, 1),
        (C,), (C, C, 1), (C,))]
    before = seanet_resblock.launches
    with pytest.raises(ValueError, match="C <= 384"):
        seanet_resblock(*args)
    assert seanet_resblock.launches == before


def test_small_encodec_roundtrip_launches_and_matches_cpu(dev):
    """Narrow widths drive the kernels' generic tiles: H=32 LSTMs and
    C=8/16 blocks (2 a side), against the same weights on the CPU."""
    mc = EncodecModelConfig(num_filters=8, hidden_size=16,
                            upsampling_ratios=(4, 2), codebook_size=64,
                            codebook_dim=16, num_quantizers=4)
    gpu = Encodec(24000, num_codebooks=4, model_config=mc, device=dev,
                  generator=torch.Generator().manual_seed(0))
    cpu = Encodec(24000, num_codebooks=4, model_config=mc, device="cpu",
                  state_dict={k: v.cpu() for k, v in gpu.state_dict().items()})
    sig = (np.random.default_rng(1).standard_normal((3, 4001)) * 0.3).astype(
        np.float32)
    n_lstm, n_block = lstm_recurrence.launches, seanet_resblock.launches
    toks = gpu.sig_to_toks(sig)
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches - n_lstm == 4
    assert seanet_resblock.launches - n_block == 4
    assert (toks.cpu() == cpu.sig_to_toks(sig)).float().mean() >= 0.999
    y_cpu = cpu.toks_to_sig(toks.cpu())
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-4 * float(
        y_cpu.abs().max())


def test_encodec_blocks_pack_once_across_roundtrips(dev):
    """The fused blocks hand the kernel their cached weight layout: four
    packs on the first roundtrip (two blocks a side), none on the second."""
    mc = EncodecModelConfig(num_filters=8, hidden_size=16,
                            upsampling_ratios=(4, 2), codebook_size=64,
                            codebook_dim=16, num_quantizers=4)
    gpu = Encodec(24000, num_codebooks=4, model_config=mc, device=dev,
                  generator=torch.Generator().manual_seed(0))
    sig = (np.random.default_rng(2).standard_normal((2, 2001)) * 0.3).astype(
        np.float32)
    packs, launches = [], []
    for _ in range(2):
        p0, n0 = pack_resblock_weights.packs, seanet_resblock.launches
        gpu.toks_to_sig(gpu.sig_to_toks(sig))
        packs.append(pack_resblock_weights.packs - p0)
        launches.append(seanet_resblock.launches - n0)
    torch.cuda.synchronize()
    assert packs == [4, 0]
    assert launches == [4, 4]


def _close(got, want):
    return float((got - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))


def _unit_args(rng, C, dev):
    return [_t(rng.standard_normal((C, C, 7)) * 0.05, dev),
            _t(rng.standard_normal(C) * 0.1, dev),
            _t(np.abs(rng.standard_normal(C)) + 0.5, dev),
            _t(rng.standard_normal((C, C, 1)) * 0.05, dev),
            _t(rng.standard_normal(C) * 0.1, dev),
            _t(np.abs(rng.standard_normal(C)) + 0.5, dev)]


@pytest.mark.parametrize("B,C,T,d", [(2, 96, 1000, 1), (2, 96, 1000, 3),
                                     (2, 96, 1000, 9), (3, 96, 1001, 9),
                                     (2, 8, 20, 9), (1, 192, 257, 3),
                                     (1, 256, 130, 9), (1, 5, 64, 1),
                                     (1, 200, 4099, 9), (1, 256, 4097, 9),
                                     (2, 192, 300, 9)])
def test_dac_resunit_kernel_matches_plain_version(dev, B, C, T, d):
    """Every tile of the kernel (C <= 96, 192, 256), C off the 8-channel
    chunk, ragged T, the widest window, and T < 6d or barely over it, where
    the padding covers most of the window; with the weights packed by the
    caller and by the wrapper."""
    rng = np.random.default_rng(B + C + T + d)
    x = _t(rng.standard_normal((B, C, T)), dev)
    args = _unit_args(rng, C, dev)
    before = _dac_launches()
    with torch.inference_mode():
        packed = pack_resunit_weights(args[0], args[3])
        got = dac_resunit(x, *args, d, packed=packed)
        got_unpacked = dac_resunit(x, *args, d)
        want = dac_resunit_reference(x, *args, d)
    torch.cuda.synchronize()
    assert _dac_launches() == before + 2
    assert _close(got, want)
    assert torch.equal(got, got_unpacked)


@pytest.mark.parametrize("C", [96, 192, 256])
def test_dac_resunit_occupancy_info(dev, C):
    """Registers a thread, shared bytes a block and blocks an SM of the tile
    the wrapper launches, at every dilation of the decoder."""
    for d in (1, 3, 9):
        info = dac_resunit_info(C, d)
        assert info["smem_bytes"] == _smem_bytes(C, d)
        assert 0 < info["regs"] <= 255
        assert info["blocks_per_sm"] >= 1


def test_dac_resunit_on_the_card_refuses_widths_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(0)
    C = 384
    x = torch.zeros(1, C, 16, device=dev)
    before = _dac_launches()
    with pytest.raises(ValueError, match="C <= 256"):
        dac_resunit(x, *_unit_args(rng, C, dev), 1)
    with pytest.raises(TypeError):
        dac_resunit(x[:, :8].double(), *[a.double() for a in
                                          _unit_args(rng, 8, dev)], 1)
    assert _dac_launches() == before


# the new forms: (precision, snake_poly, dtype)
_NEW_FORMS = [("exact", True, torch.float32),
              ("default", False, torch.float32),
              ("default", True, torch.float32),
              ("default", False, torch.bfloat16),
              ("default", True, torch.bfloat16)]
# every tile of the default form (CP = 48, 96, 192, 256), C off the
# 16-channel chunk, ragged T, T < 6d, the widest window it takes (d = 21),
# and chip_smoke.py's four odd shapes (DAC_UNIT_EXTRA)
_FORM_SHAPES = [(2, 8, 20, 9), (1, 40, 3000, 3), (2, 96, 1001, 9),
                (1, 120, 515, 1), (1, 192, 4099, 1), (1, 200, 700, 21),
                (1, 256, 4097, 9), (3, 96, 1001, 9), (1, 200, 4099, 9)]
# the default form's persistent grid (one block an SM walking the tiles):
# fewer tiles than SMs, and tile counts that are no multiple of the grid
_GRID_SHAPES = [(1, 192, 1000, 3), (1, 96, 128 * 133 + 5, 1),
                (3, 48, 128 * 88 + 1, 9), (2, 256, 128 * 140, 9)]
_ONE_PASS = [f for f in _NEW_FORMS if f[0] == "default"]
# DAC-44.1k's six decoder units at B = 1 x 10 s, BigCodec-16k's nine at
# B = 8 x 10 s
_MODEL_UNITS = [(1, 192, 220416, d) for d in (1, 3, 9)] + [
    (1, 96, 440832, d) for d in (1, 3, 9)] + [
    (8, C, T, d) for C, T in ((192, 40000), (96, 80000), (48, 160000))
    for d in (1, 3, 9)]


def _form_case(dev, B, C, T, d, dtype):
    rng = np.random.default_rng(B + C + T + d)
    x = _t(rng.standard_normal((B, C, T)) * 0.5, dev).to(dtype)
    args = [a.to(dtype) for a in _unit_args(rng, C, dev)]
    return x, args


def _check_form(x, args, d, precision, poly):
    """The kernel in a form against its plain version: the exact forms as
    the exact kernel, the default form by ``default_errors``; the launch
    counted under its form."""
    name = form_name(precision, poly, x.dtype)
    before = dac_resunit.launches_by_form[name]
    with torch.inference_mode():
        packed = pack_resunit_weights(args[0], args[3], precision)
        got = dac_resunit(x, *args, d, precision=precision,
                          snake_poly=poly, packed=packed)
        if precision == "exact":
            want = dac_resunit_reference(x, *args, d, snake_poly=poly)
            torch.cuda.synchronize()
            assert _close(got, want)
        else:
            out, h2 = dac_resunit_stages(x, *args, d, snake_poly=poly,
                                         packed=packed)
            errs = default_errors(out, h2, x, *args, d, poly)
            torch.cuda.synchronize()
            assert errs["ok"], errs
            assert torch.equal(got, out)  # h2's write changes nothing
            assert got.dtype == x.dtype
    assert dac_resunit.launches_by_form[name] - before == (
        1 if precision == "exact" else 2)


@pytest.mark.parametrize("precision,poly,dtype", _NEW_FORMS)
@pytest.mark.parametrize("B,C,T,d", _FORM_SHAPES)
def test_dac_resunit_forms_match_plain_version(dev, B, C, T, d, precision,
                                               poly, dtype):
    x, args = _form_case(dev, B, C, T, d, dtype)
    _check_form(x, args, d, precision, poly)


@pytest.mark.parametrize("precision,poly,dtype", _NEW_FORMS)
@pytest.mark.parametrize("B,C,T,d", _MODEL_UNITS)
def test_dac_resunit_forms_at_the_models_unit_shapes(dev, B, C, T, d,
                                                     precision, poly, dtype):
    x, args = _form_case(dev, B, C, T, d, dtype)
    _check_form(x, args, d, precision, poly)


@pytest.mark.parametrize("precision,poly,dtype", _ONE_PASS)
@pytest.mark.parametrize("B,C,T,d", _GRID_SHAPES)
def test_dac_resunit_default_form_on_a_persistent_grid(dev, B, C, T, d,
                                                       precision, poly,
                                                       dtype):
    x, args = _form_case(dev, B, C, T, d, dtype)
    _check_form(x, args, d, precision, poly)


@pytest.mark.parametrize("precision,poly,dtype", _NEW_FORMS)
def test_dac_resunit_form_occupancy_info(dev, precision, poly, dtype):
    """Registers, local (spill) bytes, shared bytes and blocks an SM of
    every instance a form launches at the decoders' widths and dilations;
    the one-pass instances spill nothing."""
    for C in (8, 48, 96, 120, 192, 256):
        for d in (1, 3, 9):
            info = dac_resunit_info(C, d, precision, poly, dtype)
            assert info["smem_bytes"] == _smem_bytes(C, d, precision)
            assert 0 < info["regs"] <= 255
            assert info["local_bytes"] >= 0
            if precision == "default":  # no spills; the sin instances
                # keep sinf's 32-byte slow-path array in local memory
                assert info["local_bytes"] == (0 if poly else 32), info
            assert info["blocks_per_sm"] >= 1


def test_dac_resunit_default_form_refuses_what_it_does_not_take(dev):
    x, args = _form_case(dev, 1, 16, 64, 1, torch.bfloat16)
    before = _dac_launches()
    with pytest.raises(TypeError, match="precision='default'"):
        dac_resunit(x, *args, 1)  # bf16 in the exact form
    with pytest.raises(ValueError, match="shared memory"):
        dac_resunit(x, *args, 22, precision="default")  # window > 256
    with pytest.raises(TypeError):  # weights of another dtype than x
        dac_resunit(x, *[a.float() for a in args], 1, precision="default")
    with pytest.raises(ValueError, match="packed w7"):
        dac_resunit(x.float(), *[a.float() for a in args], 1,
                    precision="default",
                    packed=pack_resunit_weights(args[0].float(),
                                                args[3].float()))
    assert _dac_launches() == before


def test_dac_resunit_default_form_has_no_gradient_on_the_card(dev):
    x, args = _form_case(dev, 1, 16, 64, 1, torch.float32)
    x.requires_grad_()
    y = dac_resunit(x, *args, 1, precision="default")
    with pytest.raises(RuntimeError, match="inference only"):
        y.sum().backward()


def _tier_pair(cls, dev, mc, preset, redraw=False, **kw):
    """The codec exact, in a tier on the card, and in the tier on the CPU,
    on one set of weights; ``redraw`` draws the convs' so that every layer
    moves the output (0.5/√fan_in convs, α = |N| + 0.5, biases 0.1·N)."""
    gpu = cls(16000, model_config=mc, device=dev,
              generator=torch.Generator().manual_seed(0), **kw)
    gen = torch.Generator().manual_seed(1)
    state = {}
    for k, v in gpu.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        if not redraw:
            pass
        elif leaf == "w" and v.ndim == 3:
            v = torch.randn(v.shape, generator=gen) * 0.5 / np.sqrt(
                v.shape[1] * v.shape[2])
        elif leaf.startswith("alpha"):
            v = torch.randn(v.shape, generator=gen).abs() + 0.5
        elif leaf == "b" and "conv" in k:
            v = torch.randn(v.shape, generator=gen) * 0.1
        state[k] = v.cpu()
    gpu.load_state_dict(state)
    tier = cls(16000, model_config=mc, device=dev, state_dict=state,
               **kw, **preset)
    cpu = cls(16000, model_config=mc, device="cpu", state_dict=state,
              **kw, **preset)
    return gpu, tier, cpu


def _rms(a):
    return float(a.float().pow(2).mean().sqrt())


def _units_fed_cpu_input(exact, tier, cpu, toks):
    """Each decoder residual unit of the tier on the card, fed the input its
    CPU twin got in the CPU's decode of ``toks``: the largest rms(card −
    CPU) as a share of the unit's own move (tier against exact on the same
    input), and the smallest share that the exact unit in the tier's place
    (the control) reads."""
    from audiocodecs_tpu_torch.models.dac import residual_unit_io

    with residual_unit_io(cpu.decoder) as (ins, outs):
        cpu.toks_to_sig(toks.cpu())
    t_units = dict(tier.decoder.named_modules())
    e_units = dict(exact.decoder.named_modules())
    worst, control = 0.0, float("inf")
    with torch.inference_mode():
        for name, x in ins.items():
            xd = x.to(next(tier.parameters()).device)
            card = t_units[name](xd).float()
            ex = e_units[name](xd.float())
            move = _rms(card - ex)
            assert move > 0
            want = outs[name].float()
            worst = max(worst, _rms(card.cpu() - want) / move)
            control = min(control, _rms(ex.cpu() - want) / move)
    assert ins
    return worst, control


def test_bigcodec_balanced_tier_on_the_card_matches_cpu(dev):
    """BigCodec's balanced preset (bf16 decoder activations, polynomial
    snake) at the published LSTM width: four wide recurrence launches and
    nine fused units in the bf16-poly form a roundtrip, tokens equal to the
    exact tier's, the card's decode within the tier's own deviation of the
    CPU's decode in the same tier (end to end the two round apart as two
    draws of the tier's error), and each residual unit, fed the CPU's own
    input, within a quarter of the unit's move of the CPU's output, where
    the exact unit reads more."""
    from audiocodecs_tpu_torch.models.bigcodec import (
        BigCodec,
        BigCodecModelConfig,
    )
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    mc = BigCodecModelConfig(ngf=48, up_ratios=(2, 2, 2, 2, 2),
                             hidden_size=64, codebook_size=256)
    exact, tier, cpu = _tier_pair(BigCodec, dev, mc,
                                  apply_serving_preset("bigcodec"))
    sig = (np.random.default_rng(2).standard_normal((2, 3200)) * 0.1).astype(
        np.float32)
    before = _launches()
    n0 = dict(dac_resunit.launches_by_form)
    toks = tier.sig_to_toks(sig)
    y = tier.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _delta(before) == (4, 0, 0, 9)
    assert dac_resunit.launches_by_form["default_poly_bf16"] - n0[
        "default_poly_bf16"] == 9
    assert torch.equal(toks, exact.sig_to_toks(sig))
    y_exact = exact.toks_to_sig(toks)
    y_cpu = cpu.toks_to_sig(toks.cpu())
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert 0 < _rms(y.cpu() - y_cpu) <= _rms(y - y_exact)
    worst, control = _units_fed_cpu_input(exact, tier, cpu, toks)
    assert worst <= 0.25 < control


@pytest.mark.parametrize("quality,batch", [("fast", 1), ("balanced", 4)])
def test_dac_tiers_on_the_card_match_cpu(dev, quality, batch):
    """DAC's fast tier (fp32, one bf16 pass) and throughput tier (bf16,
    polynomial snake) on a small config: six fused units a decode in the
    tier's form, tokens equal to the exact tier's, the card within the
    tier's own deviation of the CPU path in the same tier (rms: the two
    round to bf16 after sums taken in other orders), and each residual
    unit, fed the CPU's own input, within a quarter of the unit's move of
    the CPU's output, where the exact unit reads more."""
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    mc = DACModelConfig(encoder_hidden_size=8, downsampling_ratios=(2, 2),
                        decoder_hidden_size=64, upsampling_ratios=(2, 2),
                        hidden_size=16, n_codebooks=4, codebook_size=64,
                        codebook_dim=8)
    preset = apply_serving_preset("dac", quality, batch)
    exact, tier, cpu = _tier_pair(DAC, dev, mc, preset, redraw=True,
                                  num_codebooks=4)
    sig = (np.random.default_rng(1).standard_normal((3, 4001)) * 0.3).astype(
        np.float32)
    name = form_name(preset["decode_precision"], preset["snake_poly"],
                     preset["decode_dtype"])
    n0 = dac_resunit.launches_by_form[name]
    toks = tier.sig_to_toks(sig)
    y = tier.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert dac_resunit.launches_by_form[name] - n0 == 6
    assert torch.equal(toks, exact.sig_to_toks(sig))
    y_exact, y_cpu = exact.toks_to_sig(toks), cpu.toks_to_sig(toks.cpu())
    assert 0 < _rms(y.cpu() - y_cpu) <= _rms(y - y_exact)
    worst, control = _units_fed_cpu_input(exact, tier, cpu, toks)
    assert worst <= 0.25 < control


@pytest.mark.parametrize("C,T", [(32, 1001), (64, 77), (64, 1024)])
def test_packed_entry_matches_plain_version(dev, C, T):
    rng = np.random.default_rng(C + T)
    H = C // 2
    x = _t(rng.standard_normal((2, T, C)), dev)
    weights = [_t(rng.standard_normal(s) / np.sqrt(f), dev) for s, f in (
        ((3, C, H), 3 * C), ((H,), 3 * C), ((H, C), H), ((C,), H),
        ((C, C), C), ((C,), C))]
    before = seanet_resblock_packed.launches
    with torch.inference_mode():
        got = seanet_resblock_packed(x, *weights)
        want = seanet_resblock_packed_reference(x, *weights)
    torch.cuda.synchronize()
    assert seanet_resblock_packed.launches == before + 1
    assert tuple(got.shape) == (2, T, C)
    assert _close(got, want)


def test_small_dac_roundtrip_launches_and_matches_cpu(dev):
    """Decoder widths 32 → 16 → 8: six fused units a decode, none on the
    encode side, against the same weights on the CPU."""
    mc = DACModelConfig(encoder_hidden_size=8, downsampling_ratios=(2, 2),
                        decoder_hidden_size=32, upsampling_ratios=(2, 2),
                        hidden_size=16, n_codebooks=4, codebook_size=64,
                        codebook_dim=8)
    gpu = DAC(16000, num_codebooks=4, model_config=mc, device=dev,
              generator=torch.Generator().manual_seed(0))
    cpu = DAC(16000, num_codebooks=4, model_config=mc, device="cpu",
              state_dict={k: v.cpu() for k, v in gpu.state_dict().items()})
    sig = (np.random.default_rng(1).standard_normal((3, 4001)) * 0.3).astype(
        np.float32)
    before = _dac_launches()
    toks = gpu.sig_to_toks(sig)
    assert _dac_launches() == before
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _dac_launches() - before == 6
    assert (toks.cpu() == cpu.sig_to_toks(sig)).float().mean() >= 0.999
    y_cpu = cpu.toks_to_sig(toks.cpu())
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-4 * float(
        y_cpu.abs().max())


def test_dac_fused_units_pack_once_across_decodes(dev):
    """The decoder's fused units hand the kernel their cached weight layout:
    six packs on the first ``toks_to_sig``, none on the second, six launches
    each."""
    mc = DACModelConfig(encoder_hidden_size=8, downsampling_ratios=(2, 2),
                        decoder_hidden_size=32, upsampling_ratios=(2, 2),
                        hidden_size=16, n_codebooks=4, codebook_size=64,
                        codebook_dim=8)
    gpu = DAC(16000, num_codebooks=4, model_config=mc, device=dev,
              generator=torch.Generator().manual_seed(0))
    toks = gpu.sig_to_toks((np.random.default_rng(2).standard_normal(
        (1, 2001)) * 0.3).astype(np.float32))
    packs, launches = [], []
    for _ in range(2):
        p0, n0 = pack_resunit_weights.packs, _dac_launches()
        gpu.toks_to_sig(toks)
        packs.append(pack_resunit_weights.packs - p0)
        launches.append(_dac_launches() - n0)
    torch.cuda.synchronize()
    assert packs == [6, 0]
    assert launches == [6, 6]


def _launches():
    return (lstm_recurrence.launches, seanet_resblock.launches,
            seanet_resblock_packed.launches, _dac_launches())


def _delta(before):
    return tuple(a - b for a, b in zip(_launches(), before))


def _decode_close(got, want):
    return float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_bilstm_at_h1024_matches_cpu(dev):
    """SpeechTokenizer's encoder BiLSTM width: two layers (the second reads
    2H = 2048), four recurrence launches, against the same weights on the
    CPU's plain loop."""
    params = init_bilstm_params(torch.Generator().manual_seed(0), 2, 1024,
                                1024)
    x = torch.randn(2, 50, 1024, generator=torch.Generator().manual_seed(1))
    gpu = [{d: {k: v.to(dev) for k, v in p[d].items()} for d in p}
           for p in params]
    before = _launches()
    with torch.inference_mode():
        got = bilstm(x.to(dev), gpu)
        want = bilstm(x, params)
    torch.cuda.synchronize()
    assert _delta(before) == (4, 0, 0, 0)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def test_small_speechtokenizer_launches_and_matches_cpu(dev):
    """Encoder BiLSTM (4 launches) and decoder LSTM (2) at H = 32; the
    non-causal blocks run cuDNN, not the fused block kernel."""
    mc = SpeechTokenizerModelConfig(num_filters=8, hidden_size=32,
                                    upsampling_ratios=(4, 2), codebook_size=32,
                                    codebook_dim=32, num_quantizers=4)
    gpu = SpeechTokenizer(16000, num_codebooks=4, model_config=mc, device=dev,
                          generator=torch.Generator().manual_seed(0))
    cpu = SpeechTokenizer(16000, num_codebooks=4, model_config=mc,
                          device="cpu", state_dict={
                              k: v.cpu() for k, v in gpu.state_dict().items()})
    sig = (np.random.default_rng(1).standard_normal((3, 4001)) * 0.3).astype(
        np.float32)
    before = _launches()
    toks = gpu.sig_to_toks(sig)
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _delta(before) == (6, 0, 0, 0)
    assert (toks.cpu() == cpu.sig_to_toks(sig)).float().mean() >= 0.999
    assert _decode_close(y, cpu.toks_to_sig(toks.cpu()))


def test_bigcodec_at_h1536_launches_and_matches_cpu(dev):
    """BigCodec's published LSTM width (ngf 48 over five stride-2 stages:
    1536) on a short request: four wide recurrence launches (2 encoder,
    2 decoder layers) and nine fused units (C = 192, 96, 48) a roundtrip,
    against the same weights on the CPU."""
    from audiocodecs_tpu_torch.models.bigcodec import (
        BigCodec,
        BigCodecModelConfig,
    )

    mc = BigCodecModelConfig(ngf=48, up_ratios=(2, 2, 2, 2, 2),
                             hidden_size=64, codebook_size=256)
    gpu = BigCodec(16000, model_config=mc, device=dev,
                   generator=torch.Generator().manual_seed(0))
    cpu = BigCodec(16000, model_config=mc, device="cpu", state_dict={
        k: v.cpu() for k, v in gpu.state_dict().items()})
    sig = (np.random.default_rng(2).standard_normal((2, 3200)) * 0.1).astype(
        np.float32)
    before = _launches()
    toks = gpu.sig_to_toks(sig)
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _delta(before) == (4, 0, 0, 9)
    assert toks.shape == (2, 100, 1)
    assert (toks.cpu() == cpu.sig_to_toks(sig)).float().mean() >= 0.99
    f_gpu, f_cpu = gpu.sig_to_feats(sig).cpu(), cpu.sig_to_feats(sig)
    assert float((f_gpu - f_cpu).abs().max()) <= 1e-4 * float(
        f_cpu.abs().max())
    assert _decode_close(y, cpu.toks_to_sig(toks.cpu()))


_MIMI_SMALL = dict(sampling_rate=512, num_filters=8, hidden_size=32,
                   upsampling_ratios=(4, 2), num_hidden_layers=2,
                   num_attention_heads=2, num_key_value_heads=2, head_dim=16,
                   intermediate_size=64, sliding_window=6, codebook_size=32,
                   codebook_dim=16, num_quantizers=4, frame_rate=32.0,
                   encodec_frame_rate=64.0, upsample_groups=32)


def test_small_mimi_launches_nothing_and_matches_cpu(dev):
    mc = MimiModelConfig(**_MIMI_SMALL)
    gpu = Mimi(512, 512, num_codebooks=4, model_config=mc, device=dev,
               generator=torch.Generator().manual_seed(0))
    cpu = Mimi(512, 512, num_codebooks=4, model_config=mc, device="cpu",
               state_dict={k: v.cpu() for k, v in gpu.state_dict().items()})
    sig = (np.random.default_rng(1).standard_normal((3, 16 * 40)) * 0.3
           ).astype(np.float32)
    before = _launches()
    toks = gpu.sig_to_toks(sig)
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 0, 0)
    assert (toks.cpu() == cpu.sig_to_toks(sig)).float().mean() >= 0.999
    assert _decode_close(y, cpu.toks_to_sig(toks.cpu()))


def _stream(codec, sig, plan):
    frame = codec.frame_size
    enc = codec.init_streaming_state(sig.shape[0])
    dec = codec.init_streaming_state(sig.shape[0])
    toks, wav, pos = [], [], 0
    for m in plan:
        t, enc = codec.encode_chunk(sig[:, pos * frame:(pos + m) * frame], enc)
        w, dec = codec.decode_chunk(t, dec)
        toks.append(t)
        wav.append(w)
        pos += m
    return torch.cat(toks, 1), torch.cat(wav, 1)


@pytest.mark.parametrize("family", ["encodec", "mimi"])
def test_chunked_equals_batch_on_the_card(dev, family):
    """Zero-padded causal stacks: chunk by chunk on the card against one
    batch call on the card. EnCodec's LSTMs (H = 32) launch the recurrence
    kernel at T = chunk frames, 4 launches a chunk; Mimi launches none."""
    if family == "encodec":
        codec = Encodec(800, 800, num_codebooks=4, device=dev,
                        generator=torch.Generator().manual_seed(1),
                        model_config=EncodecModelConfig(
                            sampling_rate=800, num_filters=8, hidden_size=16,
                            upsampling_ratios=(4, 2), codebook_size=32,
                            codebook_dim=16, num_quantizers=4,
                            pad_mode="constant"))
        per_chunk = (4, 0, 0, 0)
    else:
        codec = Mimi(512, 512, num_codebooks=4, device=dev,
                     model_config=MimiModelConfig(**_MIMI_SMALL),
                     generator=torch.Generator().manual_seed(3))
        per_chunk = (0, 0, 0, 0)
    plan = [1, 3, 2, 2, 4]
    sig = (np.random.default_rng(4).standard_normal(
        (2, codec.frame_size * sum(plan))) * 0.3).astype(np.float32)
    before = _launches()
    toks, wav = _stream(codec, sig, plan)
    torch.cuda.synchronize()
    assert _delta(before) == tuple(n * len(plan) for n in per_chunk)
    batch = codec.sig_to_toks(sig)
    assert (toks == batch).float().mean() >= 0.999
    want = codec.toks_to_sig(toks).cpu()
    assert _decode_close(wav, want)


@pytest.mark.parametrize("n_fft,hop,padding", [(64, 16, "center"),
                                               (1280, 320, "center"),
                                               (1280, 320, "same")])
def test_istft_on_the_card_matches_cpu(dev, n_fft, hop, padding):
    """cuFFT's complex-to-real transform against the CPU's on spectra whose
    DC and Nyquist bins carry large imaginary parts: ``istft`` zeroes them
    on every device."""
    rng = np.random.default_rng(n_fft + len(padding))
    half = n_fft // 2 + 1
    re = rng.standard_normal((3, 40, half)).astype(np.float32)
    im = rng.standard_normal((3, 40, half)).astype(np.float32)
    im[..., 0], im[..., -1] = 80.0, -60.0
    want = istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                 padding)
    got = istft(_t(re, dev), _t(im, dev), n_fft, hop, padding)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def _pair_on_card(cls, dev, *args, **kwargs):
    gpu = cls(*args, device=dev, generator=torch.Generator().manual_seed(0),
              **kwargs)
    cpu = cls(*args, device="cpu", state_dict={
        k: v.cpu() for k, v in gpu.state_dict().items()}, **kwargs)
    return gpu, cpu


_ENC_SMALL = dict(num_filters=8, hidden_size=16, upsampling_ratios=(4, 2),
                  codebook_size=64, codebook_dim=16, num_quantizers=8)
_VOCOS_SMALL = VocosConfig(input_channels=16, dim=32, intermediate_dim=64,
                           num_layers=2, n_fft=32, hop_length=8)


@pytest.mark.parametrize("family", ["wavtokenizer", "encodec_vocos",
                                    "past"])
def test_small_new_codecs_launch_and_match_cpu(dev, family):
    """The encoders' LSTMs (H = 32) and causal blocks (2 a side) on the
    kernels; the Vocos heads are library calls; PAST's decoder launches
    both kernels too."""
    if family == "wavtokenizer":
        gpu, cpu = _pair_on_card(
            WavTokenizer, dev, 24000, model_config=WavTokenizerModelConfig(
                num_filters=8, hidden_size=32, upsampling_ratios=(4, 2),
                codebook_size=64, codebook_dim=32, vocos_dim=32,
                vocos_intermediate_dim=64, vocos_layers=2, n_fft=64,
                hop_length=8))
        per_roundtrip = (2, 2, 0, 0)
    elif family == "encodec_vocos":
        gpu, cpu = _pair_on_card(
            Encodec, dev, 24000, num_codebooks=8, use_vocos=True,
            vocos_config=_VOCOS_SMALL,
            model_config=EncodecModelConfig(**_ENC_SMALL))
        per_roundtrip = (2, 2, 0, 0)
    else:
        gpu, cpu = _pair_on_card(
            PAST, dev, 16000, num_codebooks=4, model_config=SEANetRVQConfig(
                num_filters=8, hidden_size=16, upsampling_ratios=(4, 2),
                codebook_size=64, codebook_dim=8, num_quantizers=4))
        per_roundtrip = (4, 4, 0, 0)
    sig = (np.random.default_rng(2).standard_normal((3, 4001)) * 0.3).astype(
        np.float32)
    before = _launches()
    toks = gpu.sig_to_toks(sig)
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _delta(before) == per_roundtrip
    assert (toks.cpu() == cpu.sig_to_toks(sig)).float().mean() >= 0.999
    assert _decode_close(y, cpu.toks_to_sig(toks.cpu()))


def test_past_streaming_on_the_card_matches_cpu_stream(dev):
    """Four LSTM launches a chunk (2 encoder + 2 decoder layers); the
    blocks run conv by conv, as in EnCodec's streaming."""
    gpu, cpu = _pair_on_card(
        PAST, dev, 16000, num_codebooks=4, model_config=SEANetRVQConfig(
            num_filters=8, hidden_size=16, upsampling_ratios=(4, 2),
            codebook_size=64, codebook_dim=16, num_quantizers=4))
    plan = [1, 3, 2, 4]
    sig = (np.random.default_rng(3).standard_normal(
        (2, gpu.frame_size * sum(plan))) * 0.3).astype(np.float32)
    before = _launches()
    toks, wav = _stream(gpu, sig, plan)
    torch.cuda.synchronize()
    assert _delta(before) == (4 * len(plan), 0, 0, 0)
    want_toks, want_wav = _stream(cpu, sig, plan)
    assert (toks.cpu() == want_toks).float().mean() >= 0.999
    assert _decode_close(wav, want_wav)


def test_chunked_48k_style_encodec_on_the_card_matches_cpu(dev):
    """Non-causal, normalized, 320-sample windows at stride 240: B = 2 x
    800 samples is 8 windows through one encoder call (2 LSTM launches) and
    one decoder call (2 more); the non-causal blocks run cuDNN."""
    gpu, cpu = _pair_on_card(
        Encodec, dev, 800, 800, num_codebooks=4,
        model_config=EncodecModelConfig(
            sampling_rate=800, num_filters=8, hidden_size=16,
            upsampling_ratios=(4, 2), codebook_size=64, codebook_dim=16,
            num_quantizers=4, use_causal_conv=False, normalize=True,
            chunk_length_s=0.4, overlap=0.25))
    sig = (np.random.default_rng(5).standard_normal((2, 800)) * 2.0).astype(
        np.float32)
    before = _launches()
    toks = gpu.sig_to_toks(sig)
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _delta(before) == (4, 0, 0, 0)
    assert tuple(toks.shape) == (2, 4 * 40, 4)
    assert tuple(y.shape) == (2, 3 * 240 + 320)
    assert (toks.cpu() == cpu.sig_to_toks(sig)).float().mean() >= 0.999
    assert _decode_close(y, cpu.toks_to_sig(toks.cpu()))


# --------------------------------------------------------------------------
# Training: the Functions' gradients and a full-width EnCodec step
# --------------------------------------------------------------------------


def _grads_vs_plain(fn, plain, args, g_outs):
    """Gradients of ``fn`` (the Function: kernel forward, recompute
    backward) and of ``plain`` (autograd through the plain version) for
    every tensor of ``args`` that requires grad, with the output
    gradients ``g_outs``; returns the worst forward error relative to
    max(1, max|plain output|) and the worst gradient error relative to the
    plain gradient's max|g|."""
    leaves = [a for a in args if isinstance(a, torch.Tensor)
              and a.requires_grad]
    worst_fwd, worst = 0.0, 0.0
    outs = []
    grads = []
    for f in (fn, plain):
        with exact_fp32():
            out = f(*args)
            out = out if isinstance(out, tuple) else (out,)
            loss = sum((o * g).sum() for o, g in zip(out, g_outs))
            grads.append(torch.autograd.grad(loss, leaves))
        outs.append(out)
    for o, w in zip(*outs):
        worst_fwd = max(worst_fwd, float((o - w).detach().abs().max())
                        / max(1.0, float(w.detach().abs().max())))
    for g, w in zip(*grads):
        worst = max(worst, float((g - w).abs().max())
                    / max(float(w.abs().max()), 1e-30))
    return worst_fwd, worst


def _req(a, dev):
    return _t(a, dev).requires_grad_()


@pytest.mark.parametrize("T,B,H", [(75, 8, 512), (20, 3, 1024), (5, 40, 512)])
def test_lstm_function_gradient_matches_plain_on_the_card(dev, T, B, H):
    """Forward one B1 launch (or more, B = 40 at H = 512 is two), backward
    none: the recompute runs the plain version."""
    rng = np.random.default_rng(T + B + H)
    s = 1 / np.sqrt(H)
    args = [_req(rng.standard_normal((T, B, 4 * H)) * 0.5, dev),
            _req(rng.uniform(-s, s, (H, 4 * H)), dev),
            _req(rng.standard_normal((B, H)) * 0.1, dev),
            _req(rng.standard_normal((B, H)) * 0.1, dev)]
    g_outs = [_t(rng.standard_normal(sh), dev)
              for sh in ((T, B, H), (B, H), (B, H))]
    before = lstm_recurrence.launches
    fwd, err = _grads_vs_plain(lstm_recurrence, lstm_recurrence_reference,
                               args, g_outs)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches - before == -(-B // (32 if H == 512
                                                         else 16))
    assert fwd <= 1e-5 and err <= 1e-4


@pytest.mark.parametrize("C,T,pad_mode", [(32, 24000, "reflect"),
                                          (256, 600, "constant"),
                                          (64, 3, "reflect")])
def test_block_function_gradient_matches_plain_on_the_card(dev, C, T,
                                                           pad_mode):
    """The halo built from x as the model builds it: x's gradient includes
    the halo's share."""
    rng = np.random.default_rng(C + T)
    Hc = C // 2
    x = _req(rng.standard_normal((2, C, T)), dev)
    weights = [_req(rng.standard_normal(s) / np.sqrt(f), dev) for s, f in (
        ((Hc, C, 3), 3 * C), ((Hc,), 3 * C), ((C, Hc, 1), Hc), ((C,), Hc),
        ((C, C, 1), C), ((C,), C))]
    packed = pack_resblock_weights(weights[0], weights[2], weights[4])

    def halo(x):
        return pad1d(x[..., :3], 2, 0, mode=pad_mode)[..., :2].contiguous()

    before = seanet_resblock.launches
    fwd, err = _grads_vs_plain(
        lambda x, *w: seanet_resblock(x, halo(x), *w, packed=packed),
        lambda x, *w: seanet_resblock_reference(x, halo(x), *w),
        [x, *weights], [_t(rng.standard_normal((2, C, T)), dev)])
    torch.cuda.synchronize()
    assert seanet_resblock.launches - before == 1
    assert fwd <= 1e-5 and err <= 1e-4


def test_packed_entry_function_gradient_matches_plain_on_the_card(dev):
    rng = np.random.default_rng(7)
    C, T = 64, 1001
    args = [_req(rng.standard_normal((2, T, C)), dev),
            _req(rng.standard_normal((3, C, C // 2)) / np.sqrt(3 * C), dev),
            _req(rng.standard_normal(C // 2) * 0.1, dev),
            _req(rng.standard_normal((C // 2, C)) / np.sqrt(C), dev),
            _req(rng.standard_normal(C) * 0.1, dev),
            _req(rng.standard_normal((C, C)) / np.sqrt(C), dev),
            _req(rng.standard_normal(C) * 0.1, dev)]
    before = seanet_resblock_packed.launches
    fwd, err = _grads_vs_plain(seanet_resblock_packed,
                               seanet_resblock_packed_reference, args,
                               [_t(rng.standard_normal((2, T, C)), dev)])
    torch.cuda.synchronize()
    assert seanet_resblock_packed.launches - before == 1
    assert fwd <= 1e-5 and err <= 1e-4


@pytest.mark.parametrize("C,T,d", [(192, 22050, 1), (96, 1001, 9)])
def test_dac_unit_function_gradient_matches_plain_on_the_card(dev, C, T, d):
    rng = np.random.default_rng(C + d)
    x = _req(rng.standard_normal((1, C, T)) * 0.5, dev)
    w = [_req(rng.standard_normal((C, C, 7)) / np.sqrt(7 * C), dev),
         _req(rng.standard_normal(C) * 0.1, dev),
         _req(np.abs(rng.standard_normal(C)) + 0.5, dev),
         _req(rng.standard_normal((C, C, 1)) / np.sqrt(C), dev),
         _req(rng.standard_normal(C) * 0.1, dev),
         _req(np.abs(rng.standard_normal(C)) + 0.5, dev)]
    packed = pack_resunit_weights(w[0], w[3])
    before = _dac_launches()
    fwd, err = _grads_vs_plain(
        lambda x, *w: dac_resunit(x, *w, d, packed=packed),
        lambda x, *w: dac_resunit_reference(x, *w, d),
        [x, *w], [_t(rng.standard_normal((1, C, T)), dev)])
    torch.cuda.synchronize()
    assert _dac_launches() - before == 1
    assert fwd <= 1e-5 and err <= 1e-4


def test_full_width_encodec_training_step_on_the_card(dev):
    """EnCodec-24 kHz at its published width, B = 2 x 1 s, EMA codebooks
    and the spectral term: the forward launches B1 4 times and B2 8 times,
    the backward launches neither; every encoder and decoder parameter gets
    a finite, nonzero gradient (the codebooks none: the EMA rule trains
    them); a second step repacks each block once and its blocks run the
    new weights."""
    from audiocodecs_tpu_torch.nn.seanet import (
        ResBlock,
        _apply_resnet,
        _resnet_plain,
    )
    from audiocodecs_tpu_torch.parallel.train import (
        codec_loss,
        init_codec_opt_state,
        make_codec_train_step,
    )

    model = Encodec(24000, 24000, num_codebooks=8, device=dev,
                    generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sig = torch.from_numpy((rng.standard_normal((2, 24000)) * 0.1)
                           .astype(np.float32)).to(dev)
    before = _launches()
    with exact_fp32():
        loss, (metrics, _) = codec_loss(model, sig, 8,
                                        spec_weight=torch.tensor(0.5),
                                        ema=True)
        torch.cuda.synchronize()
        fwd = _delta(before)
        loss.backward()
        torch.cuda.synchronize()
    assert fwd == (4, 8, 0, 0)
    assert _delta(before) == fwd
    for name, p in model.named_parameters():
        if name == "codebooks":
            assert p.grad is None
            continue
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        assert float(p.grad.abs().max()) > 0, name
    assert all(bool(torch.isfinite(v)) for v in metrics.values())

    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4,
                                 betas=(0.5, 0.9))
    state = init_codec_opt_state(optimizer, model, 8)
    step = make_codec_train_step(model, 8, spec_weight=1.0, spec_ramp=2)
    blocks = [m for m in model.modules() if isinstance(m, ResBlock)]
    assert len(blocks) == 8
    # the first step's forward finds the weights the layouts were built for
    # above; its update changes them, so the second step's forward repacks
    # each block once
    for want_packs in (0, 8):
        packs, before = pack_resblock_weights.packs, _launches()
        met = step(state, sig)
        torch.cuda.synchronize()
        assert _delta(before) == (4, 8, 0, 0)
        assert pack_resblock_weights.packs - packs == want_packs
        assert all(bool(torch.isfinite(v)) for v in met.values())
    # the layouts the blocks hold are the current weights', and a block
    # run through the kernel agrees with the plain path on them
    blk = blocks[0]
    for got, want in zip(blk.packed_weights(), pack_resblock_weights(
            blk.block[0].w, blk.block[1].w, blk.shortcut.w)):
        assert torch.equal(got, want)
    x = _t(rng.standard_normal((2, 32, 4001)), dev)
    cfg = model.encoder.cfg
    with torch.inference_mode():
        fused = _apply_resnet(x, blk, cfg, (1, 1))
        plain = _resnet_plain(x, blk, cfg, (1, 1))
    assert float((fused - plain).abs().max()) <= 1e-5 * max(
        1.0, float(plain.abs().max()))



# ---- B2/B3's one-pass form --------------------------------------------

# every time tile (C, Hc <= 128: 128 samples; wider: 64), widths off the
# 16-channel chunk and the 8-channel n-tile, ragged and short T, B = 1
_B2_DEFAULT_SHAPES = [
    (2, 32, 1001, "reflect"), (1, 8, 5, "reflect"), (3, 64, 257, "constant"),
    (2, 128, 300, "reflect"), (1, 256, 130, "constant"),
    (1, 384, 77, "reflect"), (2, 48, 33, "reflect"), (1, 20, 3, "constant"),
    (1, 32, 1, "reflect"), (2, 200, 129, "reflect")]
# the kernel's load paths: rows of x on 16 bytes (TMA) in both dtypes
# (T = 1024), in fp32 only (1020), in neither (1001 above); fewer items
# than SMs (16, and B = 1 with T below one item); more items than the
# blocks (walked several a block); C = 8, 40 and 384; a streamed instance
_B2_PATH_SHAPES = [(2, 40, 1024), (2, 40, 1020), (1, 8, 40), (1, 384, 200),
                   (2, 64, 512), (8, 32, 8192), (3, 256, 1000)]
# EnCodec-24k's four decoder blocks at B = 8 x 10 s
_B2_MODEL_SHAPES = [(8, 32, 240000, "reflect"), (8, 64, 120000, "reflect"),
                    (8, 128, 30000, "reflect"), (8, 256, 6000, "reflect")]


def _b2_case(dev, B, C, T, pad_mode, dtype):
    rng = np.random.default_rng(B + C + T)
    Hc = C // 2
    x = _t(rng.standard_normal((B, C, T)) * 0.5, dev)
    halo = pad1d(x[..., :3], 2, 0, mode=pad_mode)[..., :2]
    weights = [_t(rng.standard_normal(s) / np.sqrt(f), dev) for s, f in (
        ((Hc, C, 3), 3 * C), ((Hc,), 3 * C), ((C, Hc, 1), Hc), ((C,), Hc),
        ((C, C, 1), C), ((C,), C))]
    return [t.to(dtype).contiguous() for t in (x, halo, *weights)]


def _check_b2_default(args):
    """The one-pass kernel against its plain version one rounding point at
    a time; the model's launch equal to the stages launch; the model's
    launch counted under its form, the check's stages launch not."""
    name = "default_bf16" if args[0].dtype == torch.bfloat16 else \
        "default_f32"
    before = seanet_resblock.launches_by_form[name]
    with torch.inference_mode():
        packed = pack_resblock_weights(args[2], args[4], args[6], "default")
        got = seanet_resblock(*args, packed=packed, precision="default")
        out, h2, k3 = seanet_resblock_stages(*args, packed=packed)
        errs = resblock_default_errors(out, h2, k3, *args)
        torch.cuda.synchronize()
    assert errs["ok"], errs
    assert torch.equal(got, out) and got.dtype == args[0].dtype
    assert seanet_resblock.launches_by_form[name] - before == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,T,pad_mode", _B2_DEFAULT_SHAPES)
def test_resblock_default_form_matches_plain_version(dev, B, C, T, pad_mode,
                                                     dtype):
    _check_b2_default(_b2_case(dev, B, C, T, pad_mode, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("B,C,T", _B2_PATH_SHAPES)
def test_resblock_default_form_load_paths(dev, B, C, T, pad_mode, dtype):
    _check_b2_default(_b2_case(dev, B, C, T, pad_mode, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,T,pad_mode", _B2_MODEL_SHAPES)
def test_resblock_default_form_at_the_models_shapes(dev, B, C, T, pad_mode,
                                                    dtype):
    _check_b2_default(_b2_case(dev, B, C, T, pad_mode, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resblock_default_form_info(dev, dtype):
    """Registers, spills, shared bytes, blocks an SM and the time tile of
    each one-pass instance: 64-sample items, the shared bytes of the
    layout (``_mma_layout``, csrc ``mma::Cfg``) and the blocks an SM it is
    built for (2 at C <= 64, 1 above), no spills."""
    for C in (8, 32, 64, 128, 256, 384):
        info = seanet_resblock_info(C, C // 2, "default", dtype)
        lay = _resblock_mma_layout(C, C // 2, dtype)
        assert info["tile"] == 64
        assert info["smem_bytes"] == lay["smem"]
        assert info["blocks_per_sm"] == lay["MINB"]
        assert info["local_bytes"] == 0
        assert 0 < info["regs"] <= 255


def test_resblock_default_form_elu_rounds_as_expm1f_everywhere(dev):
    """The one-pass kernel's fast ELU rounds to the bf16 of ``expm1f``'s
    ELU for every float (the kernel's own check over all 2^32 bit
    patterns), so its h and h2 are the plain version's bit for bit."""
    res = seanet_resblock_elu_check()
    assert res["mismatches"] == 0, res
    assert res["max_ulps"] < 8, res  # the margin the fast path keeps


def test_resblock_default_form_refuses_what_it_does_not_take(dev):
    args = _b2_case(dev, 1, 32, 64, "reflect", torch.bfloat16)
    before = dict(seanet_resblock.launches_by_form)
    with pytest.raises(TypeError, match="precision='default'"):
        seanet_resblock(*args)  # bf16 in the exact form
    with pytest.raises(TypeError):  # weights of another dtype than x
        seanet_resblock(args[0], args[1], *[a.float() for a in args[2:]],
                        precision="default")
    f32 = [a.float() for a in args]
    with pytest.raises(ValueError, match="packed w1"):
        seanet_resblock(*f32, precision="default",
                        packed=pack_resblock_weights(f32[2], f32[4], f32[6]))
    assert seanet_resblock.launches_by_form == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T", [(32, 1001), (64, 77), (40, 1024)])
def test_packed_entry_in_the_default_form(dev, C, T, dtype):
    """B3's entry in the one-pass form launches the block kernel on the
    converted layout: bit for bit the block's launch there, counted
    apart."""
    rng = np.random.default_rng(C + T)
    Hc = C // 2
    x = _t(rng.standard_normal((2, T, C)), dev).to(dtype)
    weights = [_t(rng.standard_normal(s) / np.sqrt(f), dev).to(dtype)
               for s, f in (((3, C, Hc), 3 * C), ((Hc,), 3 * C),
                            ((Hc, C), Hc), ((C,), Hc), ((C, C), C),
                            ((C,), C))]
    name = "default_bf16" if dtype == torch.bfloat16 else "default_f32"
    before = seanet_resblock_packed.launches_by_form[name]
    with torch.inference_mode():
        got = seanet_resblock_packed(x, *weights, precision="default")
        xc = x.transpose(1, 2).contiguous()
        want = seanet_resblock(
            xc, torch.zeros_like(xc[..., :2]),
            weights[0].permute(2, 1, 0).contiguous(), weights[1],
            weights[2].T.contiguous()[..., None], weights[3],
            weights[4].T.contiguous()[..., None], weights[5],
            precision="default")
    assert seanet_resblock_packed.launches_by_form[name] == before + 1
    assert torch.equal(got, want.transpose(1, 2))


def test_encodec_tier_launches_and_matches_cpu(dev):
    """A small EnCodec in its balanced tier on the card: 2 exact and 2
    one-pass bf16 B2 launches a roundtrip (encoder, decoder), tokens equal
    to the exact codec's, the decode within the tier's move of the CPU
    path's in the same tier."""
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    mc = EncodecModelConfig(num_filters=8, hidden_size=16,
                            upsampling_ratios=(4, 2), codebook_size=64,
                            codebook_dim=16, num_quantizers=4)
    kw = apply_serving_preset("encodec")
    exact = Encodec(24000, num_codebooks=4, model_config=mc, device=dev,
                    generator=torch.Generator().manual_seed(0))
    state = {k: v.cpu() for k, v in exact.state_dict().items()}
    tier = Encodec(24000, num_codebooks=4, model_config=mc, device=dev,
                   state_dict=state, **kw)
    cpu = Encodec(24000, num_codebooks=4, model_config=mc, device="cpu",
                  state_dict=state, **kw)
    sig = (np.random.default_rng(1).standard_normal((2, 4000)) * 0.3).astype(
        np.float32)
    n0 = seanet_resblock.launches
    b0 = seanet_resblock.launches_by_form["default_bf16"]
    toks = tier.sig_to_toks(sig)
    y = tier.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert seanet_resblock.launches - n0 == 2
    assert seanet_resblock.launches_by_form["default_bf16"] - b0 == 2
    assert torch.equal(toks, exact.sig_to_toks(sig))
    move = float((y - exact.toks_to_sig(toks)).pow(2).mean().sqrt())
    gap = float((y.cpu() - cpu.toks_to_sig(toks.cpu())).pow(2).mean()
                .sqrt())
    assert move > 0 and gap <= move


def test_encodec_24k_loaded_from_a_checkpoint_launches_and_matches_cpu(dev):
    """EnCodec-24k at its published width on weights converted from a
    state dict in ``transformers``' layout (``encodec_schema``, drawn by
    ``synth_state_dict``): four B1 and eight B2 launches a roundtrip on the
    card, and its tokens equal the CPU path's on the same weights."""
    from audiocodecs_tpu_torch.convert.encodec import (
        convert_encodec_state_dict,
        encodec_schema,
    )
    from audiocodecs_tpu_torch.convert.torch_utils import synth_state_dict

    mc = EncodecModelConfig()
    state = convert_encodec_state_dict(
        synth_state_dict(encodec_schema(mc), seed=3), mc)
    gpu = Encodec(24000, num_codebooks=8, model_config=mc, state_dict=state,
                  device=dev)
    cpu = Encodec(24000, num_codebooks=8, model_config=mc, state_dict=state,
                  device="cpu")
    sig = (np.random.default_rng(3).standard_normal((2, 24000)) * 0.1).astype(
        np.float32)
    before = _launches()
    toks = gpu.sig_to_toks(sig)
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert _delta(before) == (4, 8, 0, 0)
    assert toks.shape == (2, 75, 8)
    assert torch.equal(toks.cpu(), cpu.sig_to_toks(sig))
    assert _decode_close(y, cpu.toks_to_sig(toks.cpu()))
