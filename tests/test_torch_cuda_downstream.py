"""The port's downstream pieces on the card's machine: the native WAV
reader and writer against the ``wave`` path, DNSMOS on the card against
its CPU version, UTMOS (its BiLSTM through the LSTM kernel) against its CPU
version, the profiler's FLOPs on the card against the CPU's, the LSTM
kernel at the downstream probes' width (T = 150, B = 4, H = 128) against
its plain version, one train step of the classification probe on the
card against the CPU, the Conformer at ``se.yaml``'s widths, one SE step
with it and ``knn_convert`` on tied similarities on the card against the
CPU. Every test needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_downstream.py

Tolerances: WAV arrays and bytes equal; DNSMOS within 1e-4 MOS (its convs
and mel projection run with TF32 off on both sides); UTMOS within 1e-4 of
max|score|; the profiler's card FLOPs within 1 % of the CPU's; the probe
width's outputs within 1e-5 absolute of the plain version and its
gradients (recomputed through the plain version) within 1e-4 of the
largest; the probe's step loss within 1e-5 relative and its params within
1e-4 of the largest entry of each leaf; the Conformer's output within 1e-5
of its largest and its gradients within 1e-4 of each leaf's largest; the
SE step's loss within 1e-5 relative, its gradients within 1e-4 of each
leaf's largest and 99.9 % of its params after the step within 1e-4 of
their leaf's largest; ``knn_convert``'s picks equal.
"""

import wave

import numpy as np
import pytest
import torch

from audiocodecs_tpu_torch.downstream.metrics import dnsmos
from audiocodecs_tpu_torch.utils.audio import read_wav, write_wav

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_native_wav_path_on_the_card_machine(dev, tmp_path, width):
    path = str(tmp_path / "in.wav")
    raw = np.random.default_rng(width).integers(0, 256, 2 * 999 * width,
                                                dtype=np.uint8)
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(width)
        f.setframerate(16000)
        f.writeframes(raw.tobytes())
    got, sr = read_wav(path)
    want, sr_plain = read_wav(path, native=False)
    assert sr == sr_plain == 16000
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for native in (True, False):
        write_wav(str(tmp_path / f"{native}.wav"), got, sr, native=native)
    assert (tmp_path / "True.wav").read_bytes() == (
        tmp_path / "False.wav").read_bytes()


@pytest.mark.parametrize("seconds,rate", [(3.0, 16000), (12.5, 16000),
                                          (2.0, 24000)])
def test_dnsmos_on_the_card_matches_cpu(dev, seconds, rate):
    rng = np.random.default_rng(int(seconds * 10))
    t = np.arange(int(seconds * rate)) / rate
    sig = (0.2 * np.sin(2 * np.pi * 140 * t) * (1 + np.sin(2 * np.pi * 3 * t))
           + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    got = dnsmos.dnsmos_p808(sig, rate, device=dev)
    want = dnsmos.dnsmos_p808(sig, rate, device="cpu")
    assert abs(got - want) <= 1e-4, (got, want)


def test_utmos_launches_the_lstm_kernel_and_matches_cpu(dev):
    from audiocodecs_tpu_torch.downstream.metrics import utmos
    from audiocodecs_tpu_torch.nn.wavlm import WavLMConfig
    from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence

    cfg = utmos.UTMOSConfig(ssl=WavLMConfig(
        hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
        gated_rel_pos=False), emb_dim=16, num_judges=8, judge_id=3,
        blstm_hidden=128, proj_hidden=64)
    cpu = utmos.UTMOS(cfg)
    cpu.load_state_dict(utmos.init_utmos_params(
        torch.Generator().manual_seed(0), cfg))
    card = utmos.UTMOS(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)
    wav = (np.random.default_rng(0).standard_normal((3, 16000))
           * 0.1).astype(np.float32)
    n = torch.tensor([16000, 12000, 7000])
    with torch.inference_mode():
        before = lstm_recurrence.launches
        got = utmos.apply_utmos_padded(card, torch.from_numpy(wav).to(dev),
                                       n.to(dev)).cpu()
        assert lstm_recurrence.launches - before == 2
        want = utmos.apply_utmos_padded(cpu, torch.from_numpy(wav), n)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_profiler_flops_on_the_card_match_cpu(dev):
    from audiocodecs_tpu_torch.downstream.profiler import profile_codec
    from audiocodecs_tpu_torch.models.encodec import Encodec

    card = Encodec(24000, device=dev,
                   generator=torch.Generator().manual_seed(0))
    cpu = Encodec(24000, device="cpu", state_dict={
        k: v.cpu() for k, v in card.state_dict().items()})
    got = profile_codec(card, seconds=(1,), runs=2, warmups=1)["1s"]
    want = profile_codec(cpu, seconds=(1,), runs=1, warmups=0)["1s"]
    assert abs(got["gflops"] - want["gflops"]) <= 0.01 * want["gflops"]
    assert got["memory"]["peak_bytes_in_use"] > 0


def test_lstm_kernel_at_the_probe_width_forward_and_gradient(dev):
    """B1 at (T, B, H) = (150, 4, 128): the kernel's outputs against its
    plain version, and the Function's gradient (the backward recomputes
    through the plain version) against the plain version's own."""
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence, lstm_recurrence_reference)

    T, B, H = 150, 4, 128
    g = torch.Generator().manual_seed(0)
    args = [(torch.randn(T, B, 4 * H, generator=g) * 0.5),
            (torch.rand(H, 4 * H, generator=g) * 2 - 1) / H ** 0.5,
            torch.randn(B, H, generator=g) * 0.1,
            torch.randn(B, H, generator=g) * 0.1]
    outs = [torch.randn(T, B, H, generator=g), torch.randn(B, H, generator=g),
            torch.randn(B, H, generator=g)]
    grads = {}
    with exact_fp32():
        for name, fn in (("kernel", lstm_recurrence),
                         ("plain", lstm_recurrence_reference)):
            xs = [a.to(dev).requires_grad_(True) for a in args]
            before = lstm_recurrence.launches
            ys = fn(*xs)
            launched = lstm_recurrence.launches - before
            assert launched == (1 if name == "kernel" else 0)
            torch.autograd.backward(ys, [o.to(dev) for o in outs])
            grads[name] = ([y.detach() for y in ys],
                           [x.grad for x in xs])
    for got, want in zip(grads["kernel"][0], grads["plain"][0]):
        assert float((got - want).abs().max()) <= 1e-5
    for got, want in zip(grads["kernel"][1], grads["plain"][1]):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def test_probe_train_step_on_the_card_matches_cpu(dev, tmp_path):
    """One Trainer step of the classification probe at ic.yaml's widths
    (H = 128, 128-wide embedding, K = 8 codebooks of 1024) on the card
    against the CPU, from one init and one batch of tokens."""
    from audiocodecs_tpu_torch.downstream.recipes import classification
    from audiocodecs_tpu_torch.downstream.recipes.trainer import (
        Trainer, params_to_jax)
    from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence

    K, C, N = 8, 1024, 150
    init = params_to_jax(classification.build_probe_params(
        torch.Generator().manual_seed(0), K, C, 128, 128, 3))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, C, (4, N, K)))
    length = torch.tensor([1.0, 0.8, 0.5, 0.3])
    label = torch.tensor([0, 2, 1, 0])

    def loss_fn(params, batch, generator):
        return classification.classification_loss(params, batch, generator,
                                                  vocab_size=C)

    out = {}
    for d in (dev, torch.device("cpu")):
        t = Trainer(loss_fn, classification.probe_params_from_jax(init, d),
                    output_folder=str(tmp_path / d.type))
        before = lstm_recurrence.launches
        loss, _, applied = t.step({"toks": toks.to(d),
                                   "length": length.to(d),
                                   "label": label.to(d)}, None)
        assert applied
        assert lstm_recurrence.launches - before == (d.type == "cuda")
        out[d.type] = loss, t.jax_params()
    (lc, pc), (lh, ph) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for key in ("embedding", "pool", "head"):
        for k, want in ph[key].items():
            got = pc[key][k]
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for k, want in ph["lstm"][0].items():
        got = pc["lstm"][0][k]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _conformer_pair(dev):
    from audiocodecs_tpu_torch.nn import conformer

    cfg = conformer.ConformerConfig(hidden_size=256, num_layers=4,
                                    num_heads=4, conv_kernel=31)
    state = conformer.init_conformer_params(torch.Generator().manual_seed(0),
                                            cfg)
    models = {}
    for d in (dev, torch.device("cpu")):
        m = conformer.Conformer(cfg)
        m.load_state_dict(state)
        models[d.type] = m.to(d)
    return cfg, models


def test_conformer_on_the_card_matches_cpu(dev):
    """``se.yaml``'s Conformer (d 256, 4 layers, k 31) at B = 4, T = 151:
    the output and every parameter's gradient of a weighted sum."""
    from audiocodecs_tpu_torch.nn import conformer

    cfg, models = _conformer_pair(dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 151, 256)).astype(
        np.float32))
    r = torch.from_numpy(rng.standard_normal((4, 151, 256)).astype(
        np.float32))
    out = {}
    for d, m in models.items():
        y = conformer.apply_conformer(m, x.to(d), cfg)
        grads = torch.autograd.grad((y * r.to(d)).sum(),
                                    list(m.parameters()))
        out[d] = y.detach().cpu(), [g.cpu() for g in grads]
    (y, g), (yc, gc) = out["cuda"], out["cpu"]
    assert float((y - yc).abs().max()) <= 1e-5 * float(yc.abs().max())
    for a, b in zip(g, gc):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_se_step_on_the_card_matches_cpu(dev, tmp_path):
    """One Trainer step of SE's Conformer model (K = 8 codebooks of 1024)
    on the card against the CPU, from one init and one batch: the
    gradients, the loss, and the share of parameter elements within 1e-4
    of their leaf's largest after the step (Adam's first step moves an
    element by about ``lr · g / (|g| + eps)``, so an element whose gradient
    is near ``eps`` moves by what rounding sets, on either device)."""
    from audiocodecs_tpu_torch.downstream.recipes import se
    from audiocodecs_tpu_torch.downstream.recipes.trainer import Trainer
    from audiocodecs_tpu_torch.params import flatten_tree

    K, C = 8, 1024
    cfg_t = se.encoder_config({"encoder_type": "conformer"})
    state = se.init_token_model(torch.Generator().manual_seed(0), K, C,
                                cfg_t).state_dict()
    rng = np.random.default_rng(1)
    batch = {"in_toks": torch.from_numpy(rng.integers(0, C, (4, 150, K))),
             "out_toks": torch.from_numpy(rng.integers(0, C, (4, 150, K))),
             "length": torch.tensor([1.0, 0.8, 0.5, 0.3])}
    out = {}
    for d in (dev, torch.device("cpu")):
        model = se.TokenModel(K, C, cfg_t)
        model.load_state_dict(state)
        t = Trainer(lambda m, b, g: se.se_loss(m, b, g, vocab_size=C,
                                               num_codebooks=K),
                    model.to(d), output_folder=str(tmp_path / d.type))
        b = {k: v.to(d) for k, v in batch.items()}
        loss, _ = t.compute_loss(b, None)
        grads = [g.cpu() for g in torch.autograd.grad(loss, t._leaves)]
        loss, _, applied = t.step(b, None)
        assert applied
        out[d.type] = loss, grads, flatten_tree(t.jax_params())
    (lc, gc, pc), (lh, gh, ph) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    off = sum(int((np.abs(pc[k] - w) > 1e-4 * np.abs(w).max()).sum())
              for k, w in ph.items())
    assert off <= 1e-3 * sum(w.size for w in ph.values())


def test_knn_convert_ties_on_the_card(dev):
    """Tied similarities pick the lower index on the card too (a stable
    descending sort), and the conversion equals the CPU's."""
    from audiocodecs_tpu_torch.downstream.recipes.vc import knn_convert

    rng = np.random.default_rng(2)
    match = rng.standard_normal((300, 64)).astype(np.float32)
    match[100:200] = match[:100] * 2.0  # every row tied with another
    src = rng.standard_normal((250, 64)).astype(np.float32)
    src[:50] = match[:50] * 3.0
    got = knn_convert(torch.from_numpy(src).to(dev),
                      torch.from_numpy(match).to(dev)).cpu()
    want = knn_convert(torch.from_numpy(src), torch.from_numpy(match))
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max())
