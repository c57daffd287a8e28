"""Port parity for the waveform augmentation (``audiocodecs_tpu_torch/
downstream/augment.py``) against the JAX package, on the CPU.

``jax.random``'s draws cannot be made by a ``torch.Generator``, so each
case draws with the JAX package's own key splits and feeds those draws to
the port's apply:

* DropFreq's apply (the composed 301-tap notch kernel, one depthwise
  conv): within 1e-5 absolute of ``drop_freq``;
* DropChunk's mask (boundary counts scattered into T + 1 slots, then a
  cumulative sum), with and without valid lengths: exact;
* ``build_augmenter``'s chain with its per-row coin: exact where the coin
  keeps the input, and within DropFreq's 1e-5 elsewhere;

and, on the port's own draws, properties: counts and lengths within their
bounds, chunks inside each row's valid region, the same output for the
same generator seed, and a notch that cuts its tone and passes others.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream import augment as jaugment
from audiocodecs_tpu_torch.downstream import augment
from zoo_pairs import one_thread  # noqa: F401 (autouse)


def _sig(B=3, T=4000, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T)).astype(
        np.float32) * 0.3


def _jax_freq_draws(key, B, freq_low=0.0, freq_high=1.0, count_low=1,
                    count_high=3):
    """``drop_freq``'s draws (augment.py:71-75)."""
    k1, k2 = jax.random.split(key)
    freqs = jax.random.uniform(k1, (B, count_high),
                               minval=max(freq_low, 1e-2),
                               maxval=min(freq_high, 1.0 - 1e-2))
    counts = jax.random.randint(k2, (B,), count_low, count_high + 1)
    return {"freqs": torch.from_numpy(np.array(freqs)),
            "counts": torch.from_numpy(np.array(counts))}


def _jax_chunk_draws(key, B, length_low=1, length_high=5, count_low=1000,
                     count_high=2000):
    """``drop_chunk``'s draws (augment.py:122-128)."""
    k1, k2, k3 = jax.random.split(key, 3)
    counts = jax.random.randint(k1, (B,), count_low, count_high + 1)
    lens = jax.random.randint(k2, (B, count_high), length_low,
                              length_high + 1)
    u = jax.random.uniform(k3, (B, count_high))
    return {k: torch.from_numpy(np.array(v)) for k, v in
            (("counts", counts), ("lens", lens), ("u", u))}


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"count_low": 3, "count_high": 3, "width": 0.1}),
    (2, {"freq_low": 0.2, "freq_high": 0.5, "count_high": 5}),
    (3, {"count_low": 0, "count_high": 2})])
def test_drop_freq_apply_on_jax_draws(seed, kw):
    sig = _sig(seed=seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaugment.drop_freq(jnp.asarray(sig), key, **kw))
    draw_kw = {k: v for k, v in kw.items() if k != "width"}
    draws = _jax_freq_draws(key, sig.shape[0], **draw_kw)
    got = augment.apply_drop_freq(torch.from_numpy(sig), draws,
                                  width=kw.get("width", 0.05)).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-5


@pytest.mark.parametrize("seed,lengths,kw", [
    (0, None, {}), (1, [4000, 2500, 17], {}),
    (2, [3000, 4000, 1], {"length_low": 3, "length_high": 40,
                          "count_low": 10, "count_high": 60}),
    (3, None, {"count_low": 0, "count_high": 4})])
def test_drop_chunk_mask_on_jax_draws_is_exact(seed, lengths, kw):
    sig = _sig(seed=seed) + 1.0  # no sample is zero before the drop
    key = jax.random.PRNGKey(100 + seed)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.float32)
    want = np.asarray(jaugment.drop_chunk(jnp.asarray(sig), key, jl, **kw))
    draws = _jax_chunk_draws(key, sig.shape[0], **kw)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.float32)
    got = augment.apply_drop_chunk(torch.from_numpy(sig), draws, tl).numpy()
    assert np.array_equal(got, want)
    mask = augment.drop_chunk_mask(sig.shape[1], draws, tl)
    assert np.array_equal(mask.numpy(), want == 0.0)


@pytest.mark.parametrize("seed,prob", [(0, 0.75), (5, 0.5), (6, 1.0)])
def test_augmenter_chain_on_jax_draws(seed, prob):
    cfg = {"augment_prob": prob, "drop_count_low": 20, "drop_count_high": 30,
           "drop_freq_count_high": 2}
    sig = _sig(B=6, seed=seed)
    lengths = np.asarray([4000, 3900, 2000, 1500, 4000, 333], np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaugment.build_augmenter(cfg)(
        jnp.asarray(sig), key, jnp.asarray(lengths)))
    kf, kc, kp = jax.random.split(key, 3)
    aug = augment.build_augmenter(cfg)
    draws = {"freq": _jax_freq_draws(kf, 6, count_high=2),
             "chunk": _jax_chunk_draws(kc, 6, count_low=20, count_high=30),
             "keep": torch.from_numpy(np.array(
                 jax.random.bernoulli(kp, prob, (6, 1))))}
    got = aug.apply(torch.from_numpy(sig), draws,
                    torch.from_numpy(lengths)).numpy()
    keep = draws["keep"].numpy()[:, 0]
    assert np.array_equal(got[~keep], sig[~keep])
    assert np.array_equal(want[~keep], sig[~keep])
    assert np.array_equal(got == 0.0, want == 0.0)
    assert float(np.abs(got - want).max()) <= 1e-5


def test_port_draws_stay_in_bounds_and_are_seeded():
    aug = augment.build_augmenter({"drop_count_low": 5, "drop_count_high": 9,
                                   "drop_length_low": 2,
                                   "drop_length_high": 7,
                                   "drop_freq_low": 0.3,
                                   "drop_freq_high": 0.6})
    draws = aug.draw(64, torch.Generator().manual_seed(0))
    f, c = draws["freq"], draws["chunk"]
    assert f["freqs"].shape == (64, 3) and c["lens"].shape == (64, 9)
    assert ((f["freqs"] >= 0.3) & (f["freqs"] < 0.6)).all()
    assert ((f["counts"] >= 1) & (f["counts"] <= 3)).all()
    assert ((c["counts"] >= 5) & (c["counts"] <= 9)).all()
    assert ((c["lens"] >= 2) & (c["lens"] <= 7)).all()
    assert ((c["u"] >= 0) & (c["u"] < 1)).all()
    assert draws["keep"].shape == (64, 1)
    # chunks fall inside each row's valid region
    sig = torch.ones(64, 500)
    valid = torch.randint(20, 501, (64,), generator=torch.Generator()
                          .manual_seed(1))
    out = augment.apply_drop_chunk(sig, c, valid)
    inside = torch.arange(500)[None] < valid[:, None]
    assert (out[~inside] == 1.0).all()
    assert (out[inside] == 0.0).any(dim=0).any()
    # the same seed gives the same output; another seed another one
    x = torch.from_numpy(_sig(B=4))
    a = aug(x, torch.Generator().manual_seed(7), torch.full((4,), 4000.0))
    b = aug(x, torch.Generator().manual_seed(7), torch.full((4,), 4000.0))
    c2 = aug(x, torch.Generator().manual_seed(8), torch.full((4,), 4000.0))
    assert torch.equal(a, b) and not torch.equal(a, c2)


def test_notch_cuts_its_tone_and_passes_others():
    """A 101-tap notch 0.05 wide: its centre tone comes out at a quarter of
    its level (both Blackman transitions are half-way there), a tone far
    from it within 1 %."""
    sr = 16000
    t = np.arange(8000) / sr
    draws = {"freqs": torch.tensor([[3000.0 / (sr / 2)]]),
             "counts": torch.tensor([1])}
    mid = slice(1000, 7000)  # away from the zero-padded ends
    for f0, lo, hi in ((3000.0, 0.0, 0.3), (500.0, 0.99, 1.01)):
        tone = np.sin(2 * np.pi * f0 * t).astype(np.float32)[None]
        out = augment.apply_drop_freq(torch.from_numpy(tone), draws).numpy()
        ratio = np.sqrt((out[0, mid] ** 2).mean() / (tone[0, mid] ** 2).mean())
        assert lo <= ratio <= hi, (f0, ratio)
    # an inactive slot is the identity
    draws["counts"] = torch.tensor([0])
    out = augment.apply_drop_freq(torch.from_numpy(tone), draws).numpy()
    assert float(np.abs(out - tone).max()) <= 1e-6
