"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (``nvcc``) and
skips without them. The file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: kernel against plain version 1e-5 (absolute for the LSTM,
relative to max(1, max|ref|) for the blocks and the DAC unit), the limits
``chip_smoke.py`` uses. A Function's gradient (kernel forward, backward
recomputed through the plain version) against autograd through the plain
version: 1e-4 of the plain gradient's max|g| (cuDNN may pick another
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
    pack_resunit_weights,
)
from audiocodecs_tpu_torch.ops.seanet_resblock import (
    _smem_bytes as _resblock_smem_bytes,
    pack_resblock_weights,
    seanet_resblock,
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


@pytest.mark.parametrize("H", [48, 1056])
def test_lstm_on_the_card_refuses_widths_the_kernel_does_not_take(dev, H):
    """No plain loop on the card: the kernel takes H % 32 == 0, H <= 1024."""
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
    before = dac_resunit.launches
    with torch.inference_mode():
        packed = pack_resunit_weights(args[0], args[3])
        got = dac_resunit(x, *args, d, packed=packed)
        got_unpacked = dac_resunit(x, *args, d)
        want = dac_resunit_reference(x, *args, d)
    torch.cuda.synchronize()
    assert dac_resunit.launches == before + 2
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
    before = dac_resunit.launches
    with pytest.raises(ValueError, match="C <= 256"):
        dac_resunit(x, *_unit_args(rng, C, dev), 1)
    with pytest.raises(TypeError):
        dac_resunit(x[:, :8].double(), *[a.double() for a in
                                          _unit_args(rng, 8, dev)], 1)
    assert dac_resunit.launches == before


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
    before = dac_resunit.launches
    toks = gpu.sig_to_toks(sig)
    assert dac_resunit.launches == before
    y = gpu.toks_to_sig(toks)
    torch.cuda.synchronize()
    assert dac_resunit.launches - before == 6
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
        p0, n0 = pack_resunit_weights.packs, dac_resunit.launches
        gpu.toks_to_sig(toks)
        packs.append(pack_resunit_weights.packs - p0)
        launches.append(dac_resunit.launches - n0)
    torch.cuda.synchronize()
    assert packs == [6, 0]
    assert launches == [6, 6]


def _launches():
    return (lstm_recurrence.launches, seanet_resblock.launches,
            seanet_resblock_packed.launches, dac_resunit.launches)


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
    before = dac_resunit.launches
    fwd, err = _grads_vs_plain(
        lambda x, *w: dac_resunit(x, *w, d, packed=packed),
        lambda x, *w: dac_resunit_reference(x, *w, d),
        [x, *w], [_t(rng.standard_normal((1, C, T)), dev)])
    torch.cuda.synchronize()
    assert dac_resunit.launches - before == 1
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
