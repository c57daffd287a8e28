"""Port parity: ``audiocodecs_tpu_torch`` Mimi, its transformer and its
grouped transposed conv against the JAX package's, on the same weights
(carried over by ``from_jax_params``) and the same numpy inputs, on the CPU;
and Mimi's chunked encode/decode against its batch path in the port.

Tolerances: the transformer within 1e-5 of its output's largest magnitude
(fp32 sums in another order); the grouped transposed conv at atol 1e-5.
The small config (the JAX package's streaming test config): tokens
identical, features and waveforms within 1e-4 relative; chunked against
batch as the JAX package holds it, token match 1.0 and waveform atol 1e-5,
rtol 1e-4. Full published width (B = 1, 0.5 s): features within 1e-4
relative, token_match ≥ 0.99 (2048-entry argmax margins can flip on
last-ulp differences).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.mimi import Mimi as JMimi
from audiocodecs_tpu.models.mimi import MimiModelConfig as JConfig
from audiocodecs_tpu.nn.layers import conv_transpose1d as j_convtr
from audiocodecs_tpu.nn.streaming import (
    apply_transformer_streaming as j_apply_streaming,
)
from audiocodecs_tpu.nn.streaming import (
    init_transformer_stream_state as j_init_stream,
)
from audiocodecs_tpu.nn.transformer import TransformerConfig as JTConfig
from audiocodecs_tpu.nn.transformer import apply_transformer as j_apply
from audiocodecs_tpu.nn.transformer import init_transformer_params as j_init
from audiocodecs_tpu_torch.models.mimi import (
    Mimi,
    MimiModelConfig,
    init_mimi_params,
)
from audiocodecs_tpu_torch.nn.layers import ConvTranspose1d, conv_transpose1d
from audiocodecs_tpu_torch.nn.streaming import (
    apply_transformer_streaming,
    init_transformer_stream_state,
)
from audiocodecs_tpu_torch.nn.transformer import (
    Transformer,
    TransformerConfig,
    apply_transformer,
)
from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params

# the JAX package's streaming test config
SMALL = dict(sampling_rate=512, num_filters=8, hidden_size=32,
             upsampling_ratios=(4, 2), kernel_size=7, last_kernel_size=3,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=2, head_dim=16, intermediate_size=64,
             sliding_window=6, codebook_size=32, codebook_dim=16,
             num_quantizers=4, num_semantic_quantizers=1, frame_rate=32.0,
             encodec_frame_rate=64.0, upsample_groups=32)
MIMI_FORM = dict(hidden_size=32, num_layers=2, num_heads=2, num_kv_heads=2,
                 head_dim=16, intermediate_size=64, act="gelu",
                 norm="layernorm", use_layer_scale=True, sliding_window=6)
LLAMA_FORM = dict(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                  head_dim=8, intermediate_size=48, act="swiglu",
                  norm="rmsnorm", norm_eps=1e-6, rope_theta=500000.0,
                  attention_bias=True)


def _rel_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _transformer_pair(form: dict, rng, final_norm=False):
    """A JAX param tree with every norm, bias and LayerScale drawn at
    random (the init's ones and zeros would hide a misplaced one), and the
    port's module loaded from it."""
    tree = jax.tree.map(np.array, j_init(jax.random.PRNGKey(0),
                                         JTConfig(**form)))
    if final_norm:
        tree["final_norm"] = {"g": np.ones(32, np.float32)}
    for key, a in flatten_tree(tree).items():
        if key.endswith((".g", ".b", "scale_attn", "scale_mlp")):
            a[...] = (1.0 if key.endswith(".g") else 0.0) + 0.2 * \
                rng.standard_normal(a.shape)
    model = Transformer(TransformerConfig(**form), final_norm=final_norm)
    model.load_state_dict(from_jax_params(tree, model), strict=True)
    return tree, model


@pytest.mark.parametrize("form,final_norm,T", [
    (MIMI_FORM, False, 13), (MIMI_FORM, False, 1), (LLAMA_FORM, True, 9)])
def test_apply_transformer_matches_jax(rng, form, final_norm, T):
    tree, model = _transformer_pair(form, rng, final_norm)
    x = rng.standard_normal((2, T, 32)).astype(np.float32)
    want = np.asarray(j_apply(tree, jnp.asarray(x), JTConfig(**form)))
    with torch.no_grad():
        got = apply_transformer(model, torch.from_numpy(x),
                                TransformerConfig(**form)).numpy()
    _rel_close(got, want, 1e-5)


@pytest.mark.parametrize("form", [MIMI_FORM, LLAMA_FORM])
def test_streaming_transformer_matches_jax_and_batch(rng, form):
    """Chunks of 1, 4, 2 and 5 positions, past the sliding window, with a
    window of 6 slots: the JAX package's streaming and the port's batch
    path on the whole sequence."""
    tree, model = _transformer_pair(form, rng)
    tcfg, jcfg = TransformerConfig(**form), JTConfig(**form)
    j_step = jax.jit(j_apply_streaming, static_argnums=2)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    js = j_init_stream(jcfg, 2, window=6)
    ts = init_transformer_stream_state(tcfg, 2, window=6)
    outs, pos = [], 0
    with torch.no_grad():
        for L in (1, 4, 2, 5):
            jy, js = j_step(tree, jnp.asarray(x[:, pos:pos + L]), jcfg, js)
            ty, ts = apply_transformer_streaming(
                model, torch.from_numpy(x[:, pos:pos + L]), tcfg, ts)
            _rel_close(ty.numpy(), jy, 1e-5)
            outs.append(ty.numpy())
            pos += L
        assert ts["pos"] == 12
        np.testing.assert_array_equal(ts["slot_pos"].numpy(),
                                      np.asarray(js["slot_pos"]))
        batch = apply_transformer(model, torch.from_numpy(x), tcfg).numpy()
    if form.get("sliding_window"):
        _rel_close(np.concatenate(outs, 1), batch, 1e-5)


def test_moe_config_refuses(rng):
    """A ``moe`` that is not an MoE config is refused; the MoE FFN in
    Mimi's form (gelu, LayerNorm, LayerScale, sliding window) matches the
    reference's, its aux loss too."""
    from audiocodecs_tpu.parallel.moe import MoEConfig as JMoEConfig
    from audiocodecs_tpu_torch.parallel.moe import MoEConfig

    with pytest.raises(TypeError, match="MoEConfig"):
        TransformerConfig(**MIMI_FORM, moe=object())
    kw = dict(hidden_size=32, ffn_size=48, num_experts=4,
              capacity_factor=1.0, top_k=2)
    jcfg = JTConfig(**MIMI_FORM, moe=JMoEConfig(**kw))
    cfg = TransformerConfig(**MIMI_FORM, moe=MoEConfig(**kw))
    tree = jax.tree.map(np.array, j_init(jax.random.PRNGKey(0), jcfg))
    for key, a in flatten_tree(tree).items():
        if key.endswith((".g", ".b", "scale_attn", "scale_mlp")):
            a[...] = (1.0 if key.endswith(".g") else 0.0) + 0.2 * \
                rng.standard_normal(a.shape)
    model = Transformer(cfg)
    model.load_state_dict(from_jax_params(tree, model), strict=True)
    x = rng.standard_normal((2, 13, 32)).astype(np.float32)
    want, jaux = j_apply(tree, jnp.asarray(x), jcfg, return_aux=True)
    with torch.no_grad():
        got, aux = apply_transformer(model, torch.from_numpy(x), cfg,
                                     return_aux=True)
    _rel_close(got.numpy(), want, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)


@pytest.mark.parametrize("cin,cout,groups", [(16, 16, 16), (8, 12, 4),
                                             (6, 4, 1)])
def test_grouped_convtr_bridge_matches_jax(rng, cin, cout, groups):
    """Depthwise (Mimi's upsample form), two input channels a group, and
    ungrouped: the reference's pre-flipped [K, Cin/G, Cout] weight through
    the bridge gives the same transposed conv."""
    k, stride = 4, 2
    w = rng.standard_normal((k, cin // groups, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    x = rng.standard_normal((2, 7, cin)).astype(np.float32)
    mod = ConvTranspose1d(cin, cout, k, groups=groups)
    sd = from_jax_params({"w": w, "b": b}, mod)
    assert tuple(sd["w"].shape) == (cin, cout // groups, k)
    want = np.asarray(j_convtr(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride, groups=groups))
    got = conv_transpose1d(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                           sd["w"], sd["b"], stride=stride, groups=groups)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want,
                               atol=1e-5)


def _pair(mode="reconstruct", num_codebooks=4, small=True, seed=3):
    jcfg = JConfig(**SMALL) if small else JConfig()
    sr = jcfg.sampling_rate
    jc = JMimi(sr, sr, mode=mode, num_codebooks=num_codebooks,
               model_config=jcfg, key=jax.random.PRNGKey(seed))
    tc = Mimi(sr, sr, mode=mode, num_codebooks=num_codebooks, device="cpu",
              model_config=MimiModelConfig(**dataclasses.asdict(jcfg)))
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def small_pair():
    return _pair()


@pytest.mark.parametrize("B,frames", [(2, 12), (1, 7)])
def test_small_tokens_identical_features_close(small_pair, rng, B, frames):
    jc, tc = small_pair
    sig = rng.standard_normal((B, tc.frame_size * frames)).astype(np.float32)
    j_toks = np.asarray(jc.sig_to_toks(sig))
    t_toks = tc.sig_to_toks(sig).numpy()
    assert t_toks.shape == j_toks.shape == (B, frames, 4)
    np.testing.assert_array_equal(t_toks, j_toks)
    _rel_close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)
    _rel_close(tc.sig_to_qfeats(sig).numpy(), jc.sig_to_qfeats(sig), 1e-4)


def test_small_decode_close_on_same_tokens(small_pair, rng):
    jc, tc = small_pair
    toks = rng.integers(0, 32, (2, 10, 4)).astype(np.int32)
    _rel_close(tc.toks_to_sig(toks).numpy(), jc.toks_to_sig(toks), 1e-4)
    _rel_close(tc.toks_to_qfeats(toks).numpy(), jc.toks_to_qfeats(toks), 1e-4)
    np.testing.assert_array_equal(tc.embs().detach().numpy(),
                                  np.asarray(jc.embs()))


def _stream_encode(codec, sig, plan):
    frame = codec.frame_size
    state = codec.init_streaming_state(sig.shape[0])
    outs, pos = [], 0
    for m in plan:
        toks, state = codec.encode_chunk(sig[:, pos * frame:(pos + m) * frame],
                                         state)
        outs.append(toks.numpy())
        pos += m
    return np.concatenate(outs, 1)


def _stream_decode(codec, toks, plan):
    state = codec.init_streaming_state(toks.shape[0])
    outs, pos = [], 0
    for m in plan:
        wav, state = codec.decode_chunk(toks[:, pos:pos + m], state)
        outs.append(wav.numpy())
        pos += m
    return np.concatenate(outs, 1)


def test_streaming_encode_matches_batch(small_pair, rng):
    _, tc = small_pair
    sig = rng.standard_normal((2, tc.frame_size * 12)).astype(np.float32)
    got = _stream_encode(tc, sig, [2] * 6)
    assert (got == tc.sig_to_toks(sig).numpy()).mean() == 1.0


def test_streaming_decode_matches_batch(small_pair, rng):
    _, tc = small_pair
    toks = rng.integers(0, 32, (2, 10, 4))
    got = _stream_decode(tc, toks, [2] * 5)
    np.testing.assert_allclose(got, tc.toks_to_sig(toks).numpy(), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("plan", [[1, 3, 2], [1] * 6])
def test_streaming_varying_chunk_sizes(small_pair, rng, plan):
    _, tc = small_pair
    sig = rng.standard_normal((1, tc.frame_size * sum(plan))).astype(
        np.float32)
    toks = _stream_encode(tc, sig, plan)
    assert (toks == tc.sig_to_toks(sig).numpy()).mean() == 1.0
    np.testing.assert_allclose(_stream_decode(tc, toks, plan),
                               tc.toks_to_sig(toks).numpy(), atol=1e-5,
                               rtol=1e-4)


def test_streaming_matches_jax_streaming(small_pair, rng):
    jc, tc = small_pair
    frame = tc.frame_size
    sig = rng.standard_normal((2, frame * 6)).astype(np.float32)
    js, outs = jc.init_streaming_state(2), []
    for f in range(0, 6, 3):
        toks, js = jc.encode_chunk(jnp.asarray(sig[:, f * frame:(f + 3) *
                                                   frame]), js)
        outs.append(np.asarray(toks))
    want = np.concatenate(outs, 1)
    np.testing.assert_array_equal(_stream_encode(tc, sig, [3, 3]), want)
    js, outs = jc.init_streaming_state(2), []
    for f in range(0, 6, 3):
        wav, js = jc.decode_chunk(jnp.asarray(want[:, f:f + 3]), js)
        outs.append(np.asarray(wav))
    _rel_close(_stream_decode(tc, want, [3, 3]), np.concatenate(outs, 1),
               1e-4)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_modes_prune_and_load_strict(rng, mode):
    jc, tc = _pair(mode=mode, seed=2)
    keys = set(tc.state_dict())
    assert set(flatten_tree(jax.tree.map(np.asarray, jc.params))) == keys
    other = ("decoder", "upsample") if mode == "encode" else (
        "encoder", "downsample")
    assert not any(k.startswith(other) for k in keys)
    if mode == "encode":
        sig = rng.standard_normal((1, tc.frame_size * 4)).astype(np.float32)
        np.testing.assert_array_equal(tc(sig).numpy(), np.asarray(jc(sig)))
        assert set(tc.init_streaming_state(1)) == {
            "encoder", "encoder_transformer", "downsample", "downsample_init"}
    else:
        toks = rng.integers(0, 32, (1, 5, 4)).astype(np.int32)
        _rel_close(tc(toks).numpy(), jc(toks), 1e-4)


def test_init_is_seeded_and_complete():
    mc = MimiModelConfig(**SMALL)
    a = init_mimi_params(torch.Generator().manual_seed(5), mc)
    b = init_mimi_params(torch.Generator().manual_seed(5), mc)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    tc = Mimi(512, 512, num_codebooks=3, model_config=mc, state_dict=a,
              device="cpu")
    assert set(tc.state_dict()) == set(a)
    assert tc.embs().shape == (3, 32, 16)
    assert tuple(tc.upsample.w.shape) == (32, 1, 4)


def test_full_width_features_and_tokens(rng):
    """The published config (64 filters, 8-layer transformer, 2048-entry
    codebooks of 256, 1 semantic + 7 acoustic used) at B = 1, 0.5 s."""
    jc, tc = _pair(mode="encode", num_codebooks=8, small=False, seed=0)
    sig = (rng.standard_normal((1, 12000)) * 0.1).astype(np.float32)
    jf = np.asarray(jc.sig_to_feats(sig))
    tf = tc.sig_to_feats(sig).numpy()
    assert tf.shape == jf.shape == (1, 7, 512)
    _rel_close(tf, jf, 1e-4)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 7, 8)
    assert (tt == jt).mean() >= 0.99


def _same_weights(jc, tc, K):
    """Makers of a fresh reference codec (a new trace) and of the port's,
    with ``tc``'s weights and the given constructor arguments."""
    sr = tc.sample_rate

    def make_j():
        return type(jc)(sr, sr, num_codebooks=K, model_config=jc.model_config,
                        params=jc.params)

    def make_t(**kw):
        return type(tc)(sr, sr, num_codebooks=K, model_config=tc.model_config,
                        state_dict=tc.state_dict(), device="cpu", **kw)

    return make_j, make_t


def test_serving_tier_matches_the_reference(small_pair, rng):
    """Mimi's balanced tier: its SEANet decoder in bf16 (blocks without a
    conv shortcut: the unfused path, no kernel), the transformers and the
    upsample conv exact, against the reference's under ``_ENCODEC_STYLE``'s
    switches (``tests/seanet_tier.py``)."""
    from seanet_tier import check_family_tier

    jc, tc = small_pair
    sig = rng.standard_normal((2, tc.frame_size * 12)).astype(np.float32)
    tt, _ = check_family_tier("mimi", jc, tc, *_same_weights(jc, tc, 4), sig)
    assert tt.decoder.form.dtype == torch.bfloat16 and tt.encoder.form.exact


def test_encode_precision_default_matches_the_reference(small_pair, rng):
    """The encoder stack and the downsample conv at one bf16 pass."""
    from seanet_tier import check_encode_precision

    jc, tc = small_pair
    sig = rng.standard_normal((2, tc.frame_size * 12)).astype(np.float32)
    check_encode_precision(jc, *_same_weights(jc, tc, 4), sig)
