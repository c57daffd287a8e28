"""Port parity for the downstream building blocks (``audiocodecs_tpu_torch/
downstream/models/{pooling,multihead}.py``, ``downstream/cache.py``,
``downstream/text.py``) against the JAX package, on the CPU.

* The three poolings and ``multihead_embed``/``multihead_logits`` (uniform
  and heterogeneous vocabs, both padding modes) on the same numpy-seeded
  inputs and params: within 1e-6 relative to the largest output; the
  ``-1e9`` tail exact.
* ``fused_table_from_embs`` and ``vocab_offsets``: exact.
* ``TokenCache``: a file written by either package reads back in the other,
  entry for entry.
* ``char``, ``bpe`` and ``unigram`` tokenizers trained on the synthetic
  corpus's transcripts: equal ``itos``, and ``encode``/``decode`` equal on
  every transcript and on unseen words.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocodecs_tpu.downstream import cache as jcache
from audiocodecs_tpu.downstream import text as jtext
from audiocodecs_tpu.downstream.datasets import manifest as jmanifest
from audiocodecs_tpu.downstream.datasets import synthetic as jsynthetic
from audiocodecs_tpu.downstream.models import multihead as jmultihead
from audiocodecs_tpu.downstream.models import pooling as jpooling
from audiocodecs_tpu_torch.downstream import cache, text
from audiocodecs_tpu_torch.downstream.models import multihead, pooling
from zoo_pairs import one_thread  # noqa: F401 (autouse)


def _pair(tree):
    """(torch tree, JAX tree) of the same numpy leaves."""
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("kind", ["attentional", "linear", "linear_k1",
                                  "weighted", "weighted_channel"])
def test_pooling_matches_jax(kind):
    rng = np.random.default_rng(0)
    K = 1 if kind == "linear_k1" else 4
    x = rng.standard_normal((2, 5, K, 8)).astype(np.float32)
    if kind == "attentional":
        tree = {"w1": rng.standard_normal((8, 6)).astype(np.float32) * 0.3,
                "b1": rng.standard_normal(6).astype(np.float32) * 0.1,
                "w2": rng.standard_normal(6).astype(np.float32) * 0.4}
    elif kind.startswith("linear"):
        tree = {"w": rng.standard_normal(K).astype(np.float32)}
    else:
        tree = {"logits": rng.standard_normal(K).astype(np.float32)}
    p, jp = _pair(tree)
    name = kind.split("_")[0]
    kw = {"channel_idx": 2} if kind == "weighted_channel" else {}
    got = getattr(pooling, f"{name}_pooling")(p, torch.from_numpy(x), **kw)
    want = getattr(jpooling, f"{name}_pooling")(jp, jnp.asarray(x), **kw)
    _close(got, want)


def test_pooling_inits_have_the_reference_shapes():
    g = torch.Generator().manual_seed(0)
    import jax

    key = jax.random.PRNGKey(0)
    for name, args in (("attentional", (8, 6)), ("linear", (4,)),
                       ("weighted", (4,))):
        got = getattr(pooling, f"init_{name}_pooling")(g, *args)
        want = getattr(jpooling, f"init_{name}_pooling")(key, *args)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape), (name, k)
    assert torch.equal(pooling.init_linear_pooling(g, 4)["w"],
                       torch.full((4,), 0.25))


VOCABS = {"uniform": 7, "hetero": (5, 9, 3)}


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("pad", ["none", "pad_token", "pad_is_vocab"])
def test_multihead_embed_matches_jax(vocab, pad):
    C = VOCABS[vocab]
    sizes = list(C) if isinstance(C, tuple) else [C] * 3
    rng = np.random.default_rng(1)
    rows = sum(sizes) + 1
    table = rng.standard_normal((rows, 6)).astype(np.float32)
    toks = np.stack([rng.integers(0, c + 1, (2, 4)) for c in sizes], -1)
    kw = {"none": {}, "pad_token": {"pad_token": 2},
          "pad_is_vocab": {"pad_is_vocab": True}}[pad]
    if pad == "none":
        toks = np.minimum(toks, np.asarray(sizes) - 1)
    got = multihead.multihead_embed({"table": torch.from_numpy(table)},
                                    torch.from_numpy(toks), vocab_size=C,
                                    **kw)
    want = jmultihead.multihead_embed({"table": jnp.asarray(table)},
                                      jnp.asarray(toks, jnp.int32),
                                      vocab_size=C, **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("bias", [True, False])
def test_multihead_logits_matches_jax(vocab, bias):
    C = VOCABS[vocab]
    out = sum(C) if isinstance(C, tuple) else 3 * C
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((16, out)).astype(np.float32)}
    if bias:
        tree["b"] = rng.standard_normal(out).astype(np.float32)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p, jp = _pair(tree)
    got = multihead.multihead_logits(p, torch.from_numpy(x), num_heads=3,
                                     vocab_size=C)
    want = np.asarray(jmultihead.multihead_logits(
        jp, jnp.asarray(x), num_heads=3, vocab_size=C))
    tail = want == -1e9
    assert np.array_equal(got.numpy() == -1e9, tail)
    _close(np.where(tail, 0.0, got.numpy()), np.where(tail, 0.0, want))


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("dim", [4, 12])
def test_fused_table_and_offsets_are_exact(vocab, dim):
    C = VOCABS[vocab]
    embs = np.random.default_rng(3).standard_normal((3, 9, 8)).astype(
        np.float32)
    want = jmultihead.fused_table_from_embs(embs, C, dim)
    assert np.array_equal(multihead.fused_table_from_embs(embs, C, dim),
                          want)
    assert np.array_equal(
        multihead.fused_table_from_embs(torch.from_numpy(embs), C, dim),
        want)
    assert np.array_equal(multihead.vocab_offsets(C, 3),
                          jmultihead.vocab_offsets(C, 3))
    with pytest.raises(ValueError, match="vocab sizes"):
        multihead.vocab_offsets((3, 4), 3)


def test_multihead_inits_have_the_reference_shapes():
    import jax

    g, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(0)
    for C in VOCABS.values():
        got = multihead.init_multihead_embedding(g, 3, C, 6, pad_row=True)
        want = jmultihead.init_multihead_embedding(key, 3, C, 6, pad_row=True)
        assert got["table"].shape == want["table"].shape
        got = multihead.init_multihead_linear(g, 6, 3, C)
        want = jmultihead.init_multihead_linear(key, 6, 3, C)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_token_cache_crosses_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 1024, (3, 7, 2)).astype(np.int64)
    path = str(tmp_path / "c.npz")
    w = (cache.TokenCache if writer == "port" else jcache.TokenCache)(path)
    w.put_batch(["a", "b", "c"], toks, tok_lengths=[1.0, 0.5, 3 / 7])
    w.save()
    r = (jcache.TokenCache if writer == "port" else cache.TokenCache)(path)
    assert len(r) == 3 and "b" in r and "z" not in r
    for uid, n in (("a", 7), ("b", 4), ("c", 3)):
        assert np.array_equal(r.get_batch([uid])[0], toks["abc".index(uid),
                                                          :n])
    assert np.array_equal(r.get_batch(["a", "c"]),
                          w.get_batch(["a", "c"]))
    assert r.get_batch(["a", "missing"]) is None
    # the port takes a tensor as well
    c = cache.TokenCache()
    c.put_batch(["x"], torch.from_numpy(toks[:1]))
    assert np.array_equal(c.get_batch(["x"]), toks[:1])


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    manifests = jsynthetic.prepare_synthetic(str(d), sample_rate=16000,
                                             num_utts=12)
    return [r["wrd"] for split in ("train", "valid", "test")
            for r in jmanifest.read_manifest(manifests[split])]


@pytest.mark.parametrize("token_type,num_tokens,coverage", [
    ("char", 1000, 1.0), ("bpe", 64, 1.0), ("bpe", 1000, 1.0),
    ("bpe", 40, 0.9), ("unigram", 48, 1.0), ("unigram", 1000, 0.95)])
def test_tokenizers_match_jax(transcripts, token_type, num_tokens, coverage):
    train = transcripts[: len(transcripts) // 2]
    kw = dict(token_type=token_type, num_tokens=num_tokens,
              character_coverage=coverage)
    got = text.build_tokenizer(train, **kw)
    want = jtext.build_tokenizer(train, **kw)
    assert got.itos == want.itos
    assert got.vocab_size == want.vocab_size
    assert got.blank_id == want.blank_id
    for t in transcripts + ["an unseen zebra quiz", ""]:
        ids = got.encode(t)
        assert ids == want.encode(t), t
        assert got.decode(ids) == want.decode(ids), t


def test_tokenizer_factory_rejects_unknown_types():
    with pytest.raises(ValueError, match="token_type"):
        text.build_tokenizer(["a b"], token_type="word")
