"""Helpers for the downstream recipes' port-against-JAX runs
(``tests/test_torch_{classification,asr,se,ss,slm,tts,vc}.py``): the
small EnCodec of ``tests/test_recipes.py`` in one checkpoint for both
packages, a 6-utterance synthetic corpus, a JAX run whose initial params
are captured for the port's run, and the checks of the two runs'
checkpoints, caches, decoded grids and summaries."""

import fnmatch
import os

import numpy as np

from audiocodecs_tpu.downstream.datasets import synthetic as jsynthetic
from audiocodecs_tpu.downstream.recipes import trainer as jtrainer
from audiocodecs_tpu.utils.checkpoint import load_params as jload_params
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.params import flatten_tree, to_jax_params
from audiocodecs_tpu_torch.utils.checkpoint import save_params

# tests/test_recipes.py's TINY_CODEC
TINY_CODEC = {
    "name": "encodec",
    "orig_sample_rate": 16000,
    "num_codebooks": 2,
    "model_overrides": {
        "sampling_rate": 16000, "num_filters": 4, "hidden_size": 16,
        "upsampling_ratios": [20, 16], "codebook_size": 32,
        "codebook_dim": 16, "num_quantizers": 4,
    },
}


def make_inputs(d):
    """(checkpoint path, manifests) under the directory ``d``: the port's
    seeded init of the small EnCodec in the reference's tree, and the
    corpus of ``tests/test_recipes.py``."""
    mc = EncodecModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in
                               TINY_CODEC["model_overrides"].items()})
    tc = Encodec(16000, 16000, num_codebooks=2, model_config=mc,
                 device="cpu")
    ckpt = os.path.join(d, "tiny.npz")
    save_params(ckpt, to_jax_params(tc.state_dict(), tc))
    manifests = jsynthetic.prepare_synthetic(
        os.path.join(d, "corpus"), sample_rate=16000, num_utts=6,
        min_seconds=0.3, max_seconds=0.8)
    return ckpt, manifests


def base_cfg(inputs, out, **kw):
    ckpt, manifests = inputs
    cfg = {
        "sample_rate": 16000,
        "codec": {**TINY_CODEC, "checkpoint": ckpt},
        "train_csv": manifests["train"],
        "valid_csv": manifests["valid"],
        "test_csv": manifests["test"],
        "output_folder": str(out),
        "batch_size": 2,
        "num_length_buckets": 2,
        "epochs": 1,
        "seed": 0,
    }
    cfg.update(kw)
    return cfg


def run_jax_capturing_init(monkeypatch, run, cfg):
    """``run(cfg)`` of the JAX package with its Trainer's initial params
    captured: (summary, init tree of numpy arrays)."""
    import jax

    seen = {}

    class Spy(jtrainer.Trainer):
        def __init__(self, loss_fn, params, *a, **kw):
            seen["init"] = jax.tree.map(np.asarray, params)
            super().__init__(loss_fn, params, *a, **kw)

    monkeypatch.setattr(jtrainer, "Trainer", Spy)
    summary = run(cfg)
    monkeypatch.undo()
    return summary, seen["init"]


def record_codec(monkeypatch, codec_cls, as_np, encodes=False,
                 audio_mod=None):
    """From now on, in order: every token grid ``codec_cls.toks_to_sig``
    decodes (with ``encodes``, also every grid ``sig_to_toks`` makes), as
    ``as_np`` gives it, under ``"toks"``; with ``audio_mod``, every
    waveform its ``write_wav`` writes, as (file name, array), under
    ``"wavs"``. The lists fill as the run goes."""
    seen = {"toks": [], "wavs": []}
    enc, dec = codec_cls.sig_to_toks, codec_cls.toks_to_sig

    def sig_to_toks(self, *a, **kw):
        out = enc(self, *a, **kw)
        seen["toks"].append(as_np(out))
        return out

    def toks_to_sig(self, toks, *a, **kw):
        seen["toks"].append(as_np(toks))
        return dec(self, toks, *a, **kw)

    if encodes:
        monkeypatch.setattr(codec_cls, "sig_to_toks", sig_to_toks)
    monkeypatch.setattr(codec_cls, "toks_to_sig", toks_to_sig)
    if audio_mod is not None:
        write = audio_mod.write_wav

        def write_wav(path, sig, *a, **kw):
            seen["wavs"].append((os.path.basename(path), np.asarray(sig)))
            return write(path, sig, *a, **kw)

        monkeypatch.setattr(audio_mod, "write_wav", write_wav)
    return seen


def assert_same_outputs(port_dir, jax_dir, rtol=1e-4, token_cache=True,
                        loose=None):
    """The best checkpoints within ``rtol`` of the largest entry of each
    leaf (a leaf matching a pattern of ``loose``, ``{fnmatch pattern:
    rtol}``, within that pattern's; each pattern matches a leaf), and the
    token caches equal (with ``token_cache`` False, none written: SE and SS
    keep none)."""
    got = flatten_tree(jload_params(os.path.join(port_dir, "ckpt_best.npz")))
    want = flatten_tree(jload_params(os.path.join(jax_dir, "ckpt_best.npz")))
    assert sorted(got) == sorted(want)
    loose = loose or {}
    for pattern in loose:
        assert fnmatch.filter(want, pattern), pattern
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        tol = next((t for pat, t in loose.items() if fnmatch.fnmatch(k, pat)),
                   rtol)
        assert err <= tol * float(np.abs(w).max()), (k, err)
    if not token_cache:
        assert not os.path.exists(os.path.join(port_dir, "token_cache.npz"))
        return
    with np.load(os.path.join(port_dir, "token_cache.npz")) as a, \
            np.load(os.path.join(jax_dir, "token_cache.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


# The battery's means, port against JAX: the per-utterance tolerances of
# tests/test_torch_sr.py (absolute in dB for SI-SNR, for STOI and PESQ;
# relative for the distances and the MOS); a loss, an error rate or a
# perplexity within 1e-4 relative.
SUMMARY_TOL = {"SISNR": ("abs", 1e-3), "STOI": ("abs", 1e-4),
               "PESQ": ("abs", 1e-3), "MelD": ("rel", 1e-4),
               "STFTD": ("rel", 1e-4), "DNSMOS": ("rel", 1e-4)}


def assert_same_summary(got: dict, want: dict):
    """The same keys; counts and strings equal; each battery mean (its
    name after a ``Rec``/``Ref`` prefix and a ``test_`` one) within
    :data:`SUMMARY_TOL`, every other number within 1e-4 relative."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (str, int)) and not isinstance(w, bool):
            assert g == w, (k, g, w)
            continue
        base = k[4:] if k.startswith(("Rec", "Ref")) else k
        base = base.replace("test_", "").replace("_pit", "")
        kind, tol = SUMMARY_TOL.get(base, ("rel", 1e-4))
        limit = tol * (abs(w) if kind == "rel" else 1.0)
        assert abs(g - w) <= limit, (k, g, w)
