"""Helpers for the downstream recipes' port-against-JAX runs
(``tests/test_torch_classification.py``, ``tests/test_torch_asr.py``): the
small EnCodec of ``tests/test_recipes.py`` in one checkpoint for both
packages, a 6-utterance synthetic corpus, and a JAX run whose initial
probe params are captured for the port's run."""

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


def assert_same_outputs(port_dir, jax_dir, rtol=1e-4):
    """The best checkpoints within ``rtol`` of the largest entry of each
    leaf, and the token caches equal."""
    got = flatten_tree(jload_params(os.path.join(port_dir, "ckpt_best.npz")))
    want = flatten_tree(jload_params(os.path.join(jax_dir, "ckpt_best.npz")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= rtol * float(np.abs(w).max()), (k, err)
    with np.load(os.path.join(port_dir, "token_cache.npz")) as a, \
            np.load(os.path.join(jax_dir, "token_cache.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
