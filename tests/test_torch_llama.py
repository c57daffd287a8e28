"""Port parity for the Llama-style decoder (``audiocodecs_tpu_torch/
downstream/models/llama.py``) against the JAX package, on the CPU, from the
JAX init bridged by ``llama_from_jax`` (2 layers, K = 2 codebooks, GQA).

* ``llama_embed``: exact (content bands and special rows).
* ``llama_forward``: within 1e-5 relative to the largest logit.
* A prefill then step-by-step decode through the KV cache equals a fresh
  forward at every position (within 1e-5 relative).
* Greedy ``llama_generate``: the same tokens and lengths as the JAX
  package, with EOS forced in one row and prompt conditioning added.
* ``nucleus_filter`` keeps the same set as the JAX package's
  ``_sample_top_p`` filter; nucleus sampling stays inside it.
* The MoE and remat fields reach the transformer's config as the
  reference's do (the MoE decoder's numbers are ``tests/test_torch_moe.py``);
  ``init_llama_params`` has the JAX tree's keys and shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.models import llama as jllama
from audiocodecs_tpu_torch.downstream.models import llama
from audiocodecs_tpu_torch.params import to_jax_params
from zoo_pairs import one_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=17, num_codebooks=2, hidden_size=32, num_layers=2,
          num_heads=4, num_kv_heads=2, intermediate_size=64, max_seq_len=64)
CFG = llama.LlamaConfig(**KW)
JCFG = jllama.LlamaConfig(**KW)


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX params) of one JAX init."""
    jp = jllama.init_llama_params(jax.random.PRNGKey(0), JCFG)
    jp = jax.tree.map(np.asarray, jp)
    return llama.llama_from_jax(jp, CFG, "cpu"), jax.tree.map(jnp.asarray, jp)


def _toks(rng, B, L, specials=True):
    toks = rng.integers(0, CFG.vocab_size, (B, L))
    toks[:, 0] = CFG.bos_token
    if specials:
        toks[0, -1] = CFG.pad_token
    return toks


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_embed_is_exact(pair):
    model, jp = pair
    toks = _toks(np.random.default_rng(0), 2, 9)
    got = llama.llama_embed(model, torch.from_numpy(toks), CFG)
    want = jllama.llama_embed(jp, jnp.asarray(toks, jnp.int32), JCFG)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))


def test_forward_matches_jax(pair):
    model, jp = pair
    toks = _toks(np.random.default_rng(1), 3, 11)
    with torch.no_grad():
        got = llama.llama_forward(
            model, llama.llama_embed(model, torch.from_numpy(toks), CFG), CFG)
    want = jllama.llama_forward(
        jp, jllama.llama_embed(jp, jnp.asarray(toks, jnp.int32), JCFG), JCFG)
    assert got.shape == (3, 11, 2, CFG.head_vocab)
    assert _rel(got, want) <= 1e-5
    logits, aux = llama.llama_forward(
        model, llama.llama_embed(model, torch.from_numpy(toks), CFG), CFG,
        return_aux=True)
    assert float(aux) == 0.0


def test_cached_decode_equals_fresh_forward(pair):
    model, _ = pair
    L, P = 10, 4
    toks = torch.from_numpy(_toks(np.random.default_rng(2), 2, L, False))
    with torch.no_grad():
        embs = llama.llama_embed(model, toks, CFG)
        full = llama.llama_forward(model, embs, CFG)
        cache = llama.init_kv_cache(CFG, 2, L)
        steps = [llama._run_cached(model, CFG, embs[:, :P], cache, 0)]
        for p in range(P, L):
            steps.append(llama._run_cached(model, CFG, embs[:, p:p + 1],
                                           cache, p))
    for i, got in enumerate(steps):
        assert _rel(got, full[:, P - 1 + i]) <= 1e-5, i


@pytest.mark.parametrize("case", ["plain", "eos", "conditioned"])
def test_greedy_generate_matches_jax(pair, case):
    model, jp = pair
    rng = np.random.default_rng(3)
    prompt = _toks(rng, 3, 5, False)
    add = None
    if case == "eos":
        # EOS is a head id of codebook 0: make row 1 choose it
        model = llama.llama_from_jax(jax.tree.map(np.asarray, jp), CFG)
        jp = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, jp))
        w = np.asarray(jp["head"]["w"]).copy()
        w[:, CFG.vocab_size + 1] += 3.0 * np.sign(w[:, CFG.vocab_size + 1])
        jp["head"]["w"] = jnp.asarray(w)
        with torch.no_grad():
            model.head.w.copy_(torch.from_numpy(w))
    if case == "conditioned":
        add = rng.standard_normal((3, 1, CFG.hidden_size)).astype(
            np.float32) * 0.5
    got, got_len = llama.llama_generate(
        model, CFG, torch.from_numpy(prompt), 12,
        prompt_emb_add=None if add is None else torch.from_numpy(add))
    want, want_len = jllama.llama_generate(
        jp, JCFG, jnp.asarray(prompt, jnp.int32), 12, jax.random.PRNGKey(0),
        prompt_emb_add=None if add is None else jnp.asarray(add))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_len.numpy(), np.asarray(want_len))
    if case == "eos":
        assert (got == CFG.eos_token).any()


@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, 1.0])
def test_nucleus_filter_keeps_the_same_set(top_p):
    logits = np.random.default_rng(4).standard_normal((5, 20)).astype(
        np.float32) * 2
    logits[0, :3] = 1.5  # ties
    got = llama.nucleus_filter(torch.from_numpy(logits), top_p).numpy()
    # the JAX filter, as _sample_top_p builds it before its draw
    x = jnp.asarray(logits)
    probs = jax.nn.softmax(x, axis=-1)
    order = jnp.argsort(-probs, axis=-1)
    sp = jnp.take_along_axis(probs, order, axis=-1)
    keep_sorted = (jnp.cumsum(sp, axis=-1) - sp) <= top_p
    keep = jnp.take_along_axis(keep_sorted, jnp.argsort(order, axis=-1),
                               axis=-1)
    want = np.asarray(jnp.where(keep, x, -jnp.inf))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(got[np.isfinite(got)], logits[np.isfinite(got)])


def test_nucleus_sampling_stays_in_the_nucleus(pair):
    model, _ = pair
    prompt = torch.from_numpy(_toks(np.random.default_rng(5), 4, 3, False))
    a, _ = llama.llama_generate(model, CFG, prompt, 8,
                                torch.Generator().manual_seed(0), top_p=0.5)
    b, _ = llama.llama_generate(model, CFG, prompt, 8,
                                torch.Generator().manual_seed(0), top_p=0.5)
    assert torch.equal(a, b)
    assert ((a < CFG.flat_vocab)).all()


def test_moe_and_remat_raise():
    import dataclasses

    for extra in ({"moe_experts": 2}, {"remat": True},
                  {"moe_experts": 4, "moe_ffn_size": 48, "moe_top_k": 2,
                   "moe_capacity_factor": 1.5, "moe_aux_weight": 0.01}):
        got = llama.LlamaConfig(**KW, **extra).transformer()
        want = jllama.LlamaConfig(**KW, **extra).transformer()
        assert got.remat == want.remat
        assert (got.moe is None) == (want.moe is None)
        if want.moe is not None:
            assert dataclasses.asdict(got.moe) == dataclasses.asdict(
                want.moe)
    with pytest.raises(ValueError, match="unknown act"):
        dataclasses.replace(CFG.transformer(), act="relu")


def test_init_has_the_reference_tree():
    model = llama.Llama(CFG)
    model.load_state_dict(llama.init_llama_params(
        torch.Generator().manual_seed(0), CFG))
    got = jax.tree.map(np.shape, to_jax_params(model.state_dict(), model))
    want = jax.tree.map(np.shape, jllama.init_llama_params(
        jax.random.PRNGKey(0), JCFG))
    assert got == want
