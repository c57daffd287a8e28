"""Port parity for the CTC ASR recipe (``audiocodecs_tpu_torch/downstream/
recipes/asr.py``) against the JAX package, on the CPU.

* ``masked_flip``: exact, rows of every valid length.
* ``asr_forward`` (two one-layer LSTMs, forward and masked-flipped
  backward) on the JAX init: within 1e-5 relative.
* ``ctc_loss`` against ``optax.ctc_loss`` with padded frames, repeated
  labels, a row whose label cannot fit its frames (the loss is then about
  1e5 a missing frame, finite) and a fully padded label: values within
  1e-5 relative; gradients with respect to the logits within 1e-4 of the
  row's largest on every row that fits. On the row that cannot fit, both
  packages' float32 gradients are rounding of log values near -1e5 (one
  ulp is 0.0078 there): each is held within 2.5e-3 of the port's float64
  gradient (measured over these cases: JAX 4.3e-4 to 1.95e-3, the port
  2.9e-4 to 1.7e-3; the rows that fit part by at most 2.1e-6).
* ``greedy_ctc_decode``: equal on tensors and arrays.
* ``run_asr`` end to end with ``char`` and with ``bpe`` tokens on the small
  EnCodec and the 6-utterance corpus, 1 epoch, the JAX init bridged in:
  the same WER, CER and tokens seen, ``ckpt_best.npz`` within 1e-4
  relative, the same token cache and frequency matrix. Each case makes one
  JAX run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu.downstream.recipes import asr as jasr
from audiocodecs_tpu.downstream.recipes import classification as jcls
from audiocodecs_tpu_torch.downstream.recipes import asr
from recipe_pairs import (
    assert_same_outputs,
    base_cfg,
    make_inputs,
    run_jax_capturing_init,
)
from zoo_pairs import one_thread  # noqa: F401 (autouse)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def test_masked_flip_is_exact():
    x = np.random.default_rng(0).standard_normal((5, 9, 3)).astype(
        np.float32)
    length = np.asarray([1.0, 0.5, 1 / 9, 0.0, 0.7], np.float32)
    got = asr.masked_flip(torch.from_numpy(x), torch.from_numpy(length))
    want = jasr.masked_flip(jnp.asarray(x), jnp.asarray(length))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_asr_forward_matches_jax():
    K, C, E, H, V = 2, 32, 12, 16, 11
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    init = jax.tree.map(np.asarray, {
        "embedding": jcls.build_probe_params(k1, K, C, E, H, 2)["embedding"],
        "pool": {"logits": jax.random.normal(k1, (K,))},
        "lstm_fwd": jcls.build_probe_params(k2, K, C, E, H, 2)["lstm"],
        "lstm_bwd": jcls.build_probe_params(k3, K, C, E, H, 2)["lstm"],
        "head": {"w": jax.random.normal(k4, (2 * H, V)) * H**-0.5,
                 "b": jax.random.normal(k4, (V,)) * 0.1}})
    rng = np.random.default_rng(1)
    toks = rng.integers(0, C, (3, 21, K))
    length = np.asarray([1.0, 0.62, 0.3], np.float32)
    want = jasr.asr_forward(jax.tree.map(jnp.asarray, init),
                            jnp.asarray(toks), jnp.asarray(length),
                            vocab_size=C)
    got = asr.asr_forward(asr.asr_params_from_jax(init),
                          torch.from_numpy(toks), torch.from_numpy(length),
                          vocab_size=C)
    assert _rel(got, want) <= 1e-5


def _ctc_case(seed):
    """Frames T = 12, labels N = 6: full rows, padded frames, repeats, a
    label longer than its frames, a fully padded label."""
    rng = np.random.default_rng(seed)
    B, T, N, V = 6, 12, 6, 7
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    frames = np.asarray([12, 9, 12, 3, 12, 5])
    label_lens = np.asarray([6, 4, 5, 6, 0, 3])
    labels = rng.integers(1, V, (B, N))
    labels[2, 1] = labels[2, 0]  # a repeat
    labels[2, 3] = labels[2, 2]
    labels[5, :3] = 4  # three of one label in 5 frames: needs 5, fits
    label_pad = (np.arange(N)[None] >= label_lens[:, None]).astype(np.float32)
    labels = np.where(label_pad > 0, 0, labels)
    logit_pad = (np.arange(T)[None] >= frames[:, None]).astype(np.float32)
    return logits, logit_pad, labels.astype(np.int32), label_pad


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("blank_id", [0, 3])
def test_ctc_loss_and_grads_match_optax(seed, blank_id):
    logits, logit_pad, labels, label_pad = _ctc_case(seed)

    def jloss(lg):
        per = optax.ctc_loss(lg, jnp.asarray(logit_pad), jnp.asarray(labels),
                             jnp.asarray(label_pad), blank_id=blank_id)
        return per.sum(), per

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        lg = torch.from_numpy(logits).to(dtype).requires_grad_(True)
        per = asr.ctc_loss(lg, torch.from_numpy(logit_pad).to(dtype),
                           torch.from_numpy(labels),
                           torch.from_numpy(label_pad), blank_id=blank_id)
        per.sum().backward()
        grads[dtype] = lg.grad.numpy()
        if dtype == torch.float32:
            got = per.detach().numpy()
    want, jgrad = np.asarray(want), np.asarray(jgrad)
    assert np.isfinite(got).all()
    assert float(want[3]) > 1e4  # the label that cannot fit its frames
    for b in range(len(want)):
        assert abs(got[b] - want[b]) <= 1e-5 * abs(want[b]), b
        if b != 3:
            assert _rel(grads[torch.float32][b], jgrad[b]) <= 1e-4, b
    exact = grads[torch.float64][3]
    assert _rel(grads[torch.float32][3], exact) <= 2.5e-3
    assert _rel(jgrad[3], exact) <= 2.5e-3


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 15, 6)).astype(np.float32)
    logits[0, 3:6, 2] += 9  # a run of one symbol collapses to one
    length = np.asarray([1.0, 0.6, 0.2, 0.0], np.float32)
    want = jasr.greedy_ctc_decode(logits, length, blank_id=0)
    assert asr.greedy_ctc_decode(logits, length) == want
    assert asr.greedy_ctc_decode(torch.from_numpy(logits),
                                 torch.from_numpy(length)) == want
    assert asr.greedy_ctc_decode(logits, length, blank_id=2) == \
        jasr.greedy_ctc_decode(logits, length, blank_id=2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("asr_inputs")))


@pytest.mark.parametrize("token_type", ["char", "bpe"])
def test_run_asr_matches_jax(tmp_path, monkeypatch, inputs, token_type):
    cfg = base_cfg(inputs, tmp_path / "jax", probe_hidden=16,
                   embedding_dim_probe=16, max_label_len=32,
                   token_type=token_type, num_tokens=64)
    want, init = run_jax_capturing_init(monkeypatch, jasr.run_asr, cfg)
    got = asr.run_asr({**cfg, "output_folder": str(tmp_path / "port")},
                      device="cpu", init_params=init)
    for k in ("test_WER", "test_CER", "vocab_size", "tokens_seen"):
        assert got[k] == want[k], k
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert np.array_equal(np.load(tmp_path / "port" / "freq_matrix.npy"),
                          np.load(tmp_path / "jax" / "freq_matrix.npy"))
