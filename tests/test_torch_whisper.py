"""Whisper and dWER of the port (``audiocodecs_tpu_torch/nn/whisper.py``,
``convert/whisper.py``, ``downstream/metrics/dwer.py``) against the JAX
package, on the CPU, at the toy config of ``tests/test_whisper_parity.py``
(d_model 32, 2 + 2 layers, vocabulary 97) and a 1 + 1 layer model with a
byte-level vocabulary for the metric (``tests/metric_pairs.py``).

* The converter: leaf for leaf equal to the JAX converter's on an HF
  state dict, and strict.
* Log-mel (80 and 128 bins), encoder states and decoder logits: within
  1e-4 relative of the JAX package's.
* Greedy tokens (``whisper_generate``, forced prompt prefilled): ids
  identical, and lengths; the bf16 decode runs and keeps the EOS rule.
* dWER and dCER end to end from one ``.npz`` and its tokenizer directory,
  equal to the JAX metric's transcripts; the HF-directory path reads
  ``save_pretrained``'s files without ``transformers``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.convert import whisper as jconvert
from audiocodecs_tpu.downstream.metrics import dwer_jax
from audiocodecs_tpu.nn import whisper as jwhisper
from audiocodecs_tpu_torch.convert.whisper import (
    convert_whisper_state_dict,
    whisper_config_from_hf,
)
from audiocodecs_tpu_torch.downstream.metrics import dwer
from audiocodecs_tpu_torch.downstream.metrics.external import (
    make_dwer_metric,
)
from audiocodecs_tpu_torch.nn import whisper
from audiocodecs_tpu_torch.params import from_jax_params
from metric_pairs import speech, tiny_whisper
from zoo_pairs import one_thread  # noqa: F401 (autouse)

REL = 1e-4


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def toy():
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    hf_cfg = HFConfig(
        vocab_size=97, num_mel_bins=80, d_model=32, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, encoder_ffn_dim=48, decoder_ffn_dim=48,
        max_source_positions=60, max_target_positions=40, eos_token_id=3,
        decoder_start_token_id=1, pad_token_id=0, bos_token_id=0,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    hf = WhisperForConditionalGeneration(hf_cfg).eval()
    cfg = whisper_config_from_hf(hf_cfg)
    sd = convert_whisper_state_dict(hf.state_dict(), cfg)
    model = whisper.Whisper(cfg)
    model.load_state_dict(sd)
    jcfg = jconvert.whisper_config_from_hf(hf_cfg)
    jparams = jconvert.convert_whisper_state_dict(hf.state_dict(), jcfg)
    return hf, model, jax.tree.map(jnp.asarray, jparams), jcfg, jparams


def test_converter_matches_jax_leaf_for_leaf(toy):
    hf, model, _, jcfg, jparams = toy
    got = convert_whisper_state_dict(hf.state_dict(), model.cfg)
    want = from_jax_params(jparams, model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert model.cfg == whisper.WhisperConfig(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    sd = dict(hf.state_dict())
    sd["model.encoder.layers.0.bogus.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unmapped"):
        convert_whisper_state_dict(sd, model.cfg)


@pytest.mark.parametrize("bins", [80, 128])
def test_log_mel_matches_jax(bins):
    wav = (np.random.default_rng(bins).standard_normal((2, 16000 * 2))
           * 0.1).astype(np.float32)
    _close(whisper.log_mel_spectrogram(torch.from_numpy(wav), bins),
           jwhisper.log_mel_spectrogram(jnp.asarray(wav), bins))


@torch.no_grad()
def test_encoder_and_decoder_logits_match_jax(toy):
    _, model, jparams, jcfg, _ = toy
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 120, 80)).astype(np.float32)
    enc = whisper.whisper_encode(model, torch.from_numpy(mel))
    jenc = jwhisper.whisper_encode(jparams, jnp.asarray(mel), jcfg)
    _close(enc, jenc)
    toks = rng.integers(0, 97, (2, 7))
    _close(whisper.whisper_decode(model, torch.from_numpy(toks), enc),
           jwhisper.whisper_decode(jparams, jnp.asarray(toks), jenc, jcfg))


@torch.no_grad()
def test_greedy_tokens_match_jax(toy):
    _, model, jparams, jcfg, _ = toy
    mel = np.random.default_rng(1).standard_normal(
        (2, 120, 80)).astype(np.float32)
    forced = [1, 5, 6]
    toks, lengths = whisper.whisper_generate(model, torch.from_numpy(mel),
                                             forced, max_new_tokens=12)
    jtoks, jlengths = jax.jit(lambda p, m: jwhisper.whisper_generate(
        p, jcfg, m, forced, max_new_tokens=12))(jparams, jnp.asarray(mel))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    # teacher forcing on the greedy ids: each step's argmax is the next id
    seq = torch.cat([torch.tensor([forced] * 2), toks], dim=1)
    logits = whisper.whisper_decode(
        model, seq, whisper.whisper_encode(model, torch.from_numpy(mel)))
    L = len(forced)
    for b in range(2):
        n = int(lengths[b])
        np.testing.assert_array_equal(
            logits[b, L - 1:L - 1 + n].argmax(-1).numpy(),
            toks[b, :n].numpy())
    btoks, blengths = whisper.whisper_generate(
        model, torch.from_numpy(mel), forced, max_new_tokens=12,
        decode_dtype=torch.bfloat16)
    assert btoks.shape == toks.shape and btoks.dtype == torch.int64
    for b in range(2):
        n = int(blengths[b])
        assert (btoks[b, :n] != model.cfg.eos_token).all()
        assert (btoks[b, n:] == model.cfg.eos_token).all()


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("whisper")
    tiny_whisper(d)
    return d


def test_dwer_end_to_end_matches_jax(whisper_dir):
    port = dwer.make_dwer_checkpoint_metric(
        str(whisper_dir / "whisper.npz"), str(whisper_dir),
        max_new_tokens=6, device="cpu")
    ref = dwer_jax.make_dwer_jax_metric(
        str(whisper_dir / "whisper.npz"), str(whisper_dir), max_new_tokens=6)
    sigs = [speech(1.0, 0), speech(0.7, 1)]
    hyp = [s + 0.05 * np.random.default_rng(i).standard_normal(
        s.size).astype(np.float32) for i, s in enumerate(sigs)]
    assert port.transcribe(sigs + hyp, 16000) == ref.transcribe(
        sigs + hyp, 16000)
    assert port.metric(hyp, sigs, 16000) == ref.metric(hyp, sigs, 16000)
    assert port.cer(hyp, sigs, 16000) == ref.cer(hyp, sigs, 16000)
    assert all(v == 0.0 for v in port.metric(sigs, sigs, 16000))
    assert port.normalize("Mr. Smith won't!") == "mister smith will not"
    # the HF directory, read without transformers, transcribes the same
    hf_dir = make_dwer_metric(str(whisper_dir / "hf"), device="cpu")
    for k, v in port.model.state_dict().items():
        assert torch.equal(hf_dir.model.state_dict()[k], v), k
    same = dwer.dwer_metric(port.model, str(whisper_dir))  # 224 new tokens
    assert hf_dir.transcribe(sigs, 16000) == same.transcribe(sigs, 16000)


def test_forced_tokens_match_jax(whisper_dir):
    from audiocodecs_tpu_torch.utils.bytebpe import ByteLevelBPE

    from audiocodecs_tpu.utils.bytebpe import ByteLevelBPE as JBPE

    port = ByteLevelBPE.from_dir(str(whisper_dir))
    ref = JBPE.from_dir(str(whisper_dir))
    start = port.token_id("<|startoftranscript|>")
    for ml in (None, True, False):
        assert dwer.whisper_forced_tokens(port, start, "en",
                                          multilingual=ml) == \
            dwer_jax.whisper_forced_tokens(ref, start, "en", multilingual=ml)
    with pytest.raises(ValueError, match="english"):
        dwer.whisper_forced_tokens(port, start, "english")
