"""Helpers of the metric-model port tests (``tests/test_torch_whisper.py``,
``test_torch_gpt2.py``, ``test_torch_external.py``): tokenizer files the
tests write themselves (a byte-level vocabulary with Whisper's special
tokens, and a few BPE merges), and tiny HF Whisper and GPT-2 models saved
both as the reference's converted ``.npz`` (read by both packages) and as
HF directories (``config.json``, the weights, the tokenizer files)."""

import json

import numpy as np
import torch

WHISPER_SPECIALS = ("<|endoftext|>", "<|startoftranscript|>", "<|en|>",
                    "<|transcribe|>", "<|notimestamps|>")


def byte_vocab(specials=WHISPER_SPECIALS, size=None):
    """256 byte tokens, GPT-2's merge chains "the", "Ġthe", "cat", and the
    special tokens; padded with filler tokens up to ``size``."""
    from audiocodecs_tpu_torch.utils.bytebpe import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    sp = b2u[ord(" ")]
    merges = [("t", "h"), ("th", "e"), (sp, "t"), (sp + "t", "h"),
              (sp + "th", "e"), ("a", "t"), ("c", "at")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    while size is not None and len(vocab) < size - len(specials):
        vocab[f"<filler{len(vocab)}>"] = len(vocab)
    for t in specials:
        vocab[t] = len(vocab)
    return vocab, merges


def write_tokenizer(d, vocab, merges):
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


def tiny_whisper(d, num_mel_bins=80, seed=1):
    """A toy HF Whisper (d_model 32, 1 + 1 layers, 1500 source positions
    for the 30 s window) with the vocabulary of :func:`byte_vocab`: its
    converted ``whisper.npz`` (JAX converter) with ``vocab.json``,
    ``merges.txt`` and ``config.json`` in ``d``, and the HF directory
    ``d/hf`` (``save_pretrained`` plus the tokenizer files). Returns the
    HF model."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    from audiocodecs_tpu.convert.whisper import (
        convert_whisper_state_dict,
        whisper_config_from_hf,
    )
    from audiocodecs_tpu.utils.checkpoint import save_params

    vocab, merges = byte_vocab()
    hf_cfg = HFConfig(
        vocab_size=len(vocab), num_mel_bins=num_mel_bins, d_model=32,
        encoder_layers=1, encoder_attention_heads=4,
        decoder_layers=1, decoder_attention_heads=4,
        encoder_ffn_dim=48, decoder_ffn_dim=48,
        max_source_positions=1500, max_target_positions=48,
        eos_token_id=vocab["<|endoftext|>"],
        decoder_start_token_id=vocab["<|startoftranscript|>"],
        pad_token_id=0, bos_token_id=0,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    params = convert_whisper_state_dict(model.state_dict(),
                                        whisper_config_from_hf(hf_cfg))
    save_params(str(d / "whisper.npz"), params)
    write_tokenizer(d, vocab, merges)
    (d / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    model.save_pretrained(str(d / "hf"))
    write_tokenizer(d / "hf", vocab, merges)
    return model


def tiny_gpt2(d, seed=0):
    """A toy HF GPT-2 (2 layers, 32 wide, vocabulary of :func:`byte_vocab`
    with ``<|endoftext|>`` only): ``gpt2.npz`` with the tokenizer files and
    ``config.json`` in ``d``, and the HF directory ``d/hf``. Returns the
    HF model."""
    from transformers import GPT2Config as HFConfig
    from transformers import GPT2LMHeadModel

    from audiocodecs_tpu.convert.gpt2 import (
        convert_gpt2_state_dict,
        gpt2_config_from_hf,
    )
    from audiocodecs_tpu.utils.checkpoint import save_params

    vocab, merges = byte_vocab(specials=("<|endoftext|>",))
    hf_cfg = HFConfig(vocab_size=len(vocab), n_positions=64, n_embd=32,
                      n_layer=2, n_head=4, resid_pdrop=0.0, embd_pdrop=0.0,
                      attn_pdrop=0.0)
    torch.manual_seed(seed)
    model = GPT2LMHeadModel(hf_cfg).eval()
    save_params(str(d / "gpt2.npz"), convert_gpt2_state_dict(
        model.state_dict(), gpt2_config_from_hf(hf_cfg)))
    write_tokenizer(d, vocab, merges)
    (d / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    model.save_pretrained(str(d / "hf"))
    write_tokenizer(d / "hf", vocab, merges)
    return model


def speech(seconds, seed, rate=16000):
    """A voiced synthetic signal (a 140 Hz buzz under a slow envelope)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    return (0.2 * np.sin(2 * np.pi * 140 * t) * (1 + np.sin(2 * np.pi * 3 * t))
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
