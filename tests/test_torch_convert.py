"""The port's checkpoint converters for the HF families (EnCodec, DAC,
Mimi, WavLM / wav2vec2, w2v-BERT) against the JAX package's and against
the upstream PyTorch implementation that ``transformers`` installs.

* Against the JAX package: one upstream state dict through the port's
  converter and through ``from_jax_params(audiocodecs_tpu.convert.…(sd),
  port_model)``: the same keys, every tensor equal bit for bit, weight-norm
  folds within 2 float32 ulp. At a small config (an HF model's random
  ``state_dict()``) and at a published one (the HF model's keys and shapes
  built on the meta device, filled by a seeded generator): numpy work only.
* Against the oracle: the port's codec loaded through its converter gives
  the HF model's tokens exactly and its waveform and hidden states within
  the JAX parity tests' tolerances (``tests/test_encodec_parity.py``,
  ``test_dac_parity.py``, ``test_mimi_parity.py``,
  ``test_wavlm_parity.py``, ``test_w2vbert_parity.py``).
* Schemas: ``encodec_schema``/``dac_schema`` are HF's ``state_dict()``
  surface at the published configs.
* Strictness: a missing key raises; both weight-norm namings give the same
  weights.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from audiocodecs_tpu.convert import dac as jax_dac  # noqa: E402
from audiocodecs_tpu.convert import encodec as jax_encodec  # noqa: E402
from audiocodecs_tpu.convert import mimi as jax_mimi  # noqa: E402
from audiocodecs_tpu.convert import w2vbert as jax_w2vbert  # noqa: E402
from audiocodecs_tpu.convert import wavlm as jax_wavlm  # noqa: E402
from audiocodecs_tpu_torch.convert.dac import (  # noqa: E402
    convert_dac_state_dict,
    dac_config_from_hf,
    dac_schema,
)
from audiocodecs_tpu_torch.convert.encodec import (  # noqa: E402
    convert_encodec_state_dict,
    encodec_config_from_hf,
    encodec_schema,
)
from audiocodecs_tpu_torch.convert.mimi import (  # noqa: E402
    convert_mimi_state_dict,
    mimi_config_from_hf,
)
from audiocodecs_tpu_torch.convert.torch_utils import (  # noqa: E402
    fold_weight_norm_np,
    synth_state_dict,
)
from audiocodecs_tpu_torch.convert.w2vbert import (  # noqa: E402
    convert_w2vbert_state_dict,
)
from audiocodecs_tpu_torch.convert.wavlm import (  # noqa: E402
    convert_wavlm_state_dict,
    wav2vec2_config_from_hf,
    wavlm_config_from_hf,
)
from audiocodecs_tpu_torch.models.dac import DAC, dac_rvq_encode  # noqa: E402
from audiocodecs_tpu_torch.models.encodec import Encodec  # noqa: E402
from audiocodecs_tpu_torch.models.mimi import Mimi  # noqa: E402
from audiocodecs_tpu_torch.nn.w2vbert import (  # noqa: E402
    W2VBert,
    W2VBertConfig,
    apply_w2vbert,
)
from audiocodecs_tpu_torch.nn.wavlm import WavLM, apply_wavlm  # noqa: E402
from audiocodecs_tpu_torch.params import from_jax_params  # noqa: E402
from zoo_pairs import assert_same_state, one_thread  # noqa: E402,F401

_QUIET = dict(layerdrop=0.0, hidden_dropout=0.0, attention_dropout=0.0,
              feat_proj_dropout=0.0, activation_dropout=0.0)


# ----------------------------------------------------------------------- #
# Helpers
# ----------------------------------------------------------------------- #


def meta_schema(model_cls, cfg) -> dict:
    """An HF model's state-dict keys and shapes, built on the meta device
    (no memory, no init time)."""
    with torch.device("meta"):
        model = model_cls(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _wn_conv(k: str) -> bool:
    return k.endswith(".w")


def _hf_encodec(seed=0, causal=True, pad_mode="reflect"):
    """The small config of ``tests/test_encodec_parity.py``: 4 quantizers,
    codebooks redrawn N(0, 1)."""
    from transformers import EncodecConfig, EncodecModel

    torch.manual_seed(seed)
    cfg = EncodecConfig(
        target_bandwidths=[0.5, 2.0], sampling_rate=800, audio_channels=1,
        normalize=False, chunk_length_s=None, overlap=None, hidden_size=16,
        num_filters=4, num_residual_layers=1, upsampling_ratios=[4, 2],
        kernel_size=7, last_kernel_size=7, residual_kernel_size=3,
        dilation_growth_rate=2, use_causal_conv=causal, pad_mode=pad_mode,
        compress=2, num_lstm_layers=2, trim_right_ratio=1.0,
        codebook_size=32, codebook_dim=16)
    model = EncodecModel(cfg).eval()
    with torch.no_grad():
        for layer in model.quantizer.layers:
            layer.codebook.embed.normal_()
    return model, cfg


def _hf_dac():
    """The small config of ``tests/test_dac_parity.py``."""
    from transformers import DacConfig, DacModel

    torch.manual_seed(0)
    cfg = DacConfig(encoder_hidden_size=16, downsampling_ratios=[4, 5],
                    decoder_hidden_size=64, upsampling_ratios=[5, 4],
                    n_codebooks=4, codebook_size=32, codebook_dim=4,
                    hidden_size=24, sampling_rate=16000)
    model = DacModel(cfg).eval()
    with torch.no_grad():  # spread the codebooks (init is a tight normal)
        for q in model.quantizer.quantizers:
            q.codebook.weight.mul_(20.0)
    return model, cfg


_MIMI_SMALL = dict(
    sampling_rate=512, audio_channels=1, num_filters=8, hidden_size=32,
    upsampling_ratios=[4, 2], kernel_size=7, last_kernel_size=3,
    residual_kernel_size=3, num_residual_layers=1, dilation_growth_rate=2,
    use_causal_conv=True, pad_mode="constant", compress=2,
    trim_right_ratio=1.0, num_hidden_layers=2, num_attention_heads=2,
    num_key_value_heads=2, head_dim=16, intermediate_size=64, norm_eps=1e-5,
    rope_theta=10000.0, sliding_window=5, layer_scale_initial_scale=0.01,
    codebook_size=32, codebook_dim=16, num_quantizers=4,
    num_semantic_quantizers=1, vector_quantization_hidden_dimension=16,
    upsample_groups=32, frame_rate=32.0, use_streaming=False)


def _hf_mimi():
    """The small config of ``tests/test_mimi_parity.py``."""
    from transformers import MimiConfig, MimiModel

    torch.manual_seed(0)
    cfg = MimiConfig(**_MIMI_SMALL)
    model = MimiModel(cfg).eval()
    with torch.no_grad():
        for rvq in (model.quantizer.semantic_residual_vector_quantizer,
                    model.quantizer.acoustic_residual_vector_quantizer):
            for layer in rvq.layers:
                layer.codebook.embed_sum.normal_()
                layer.codebook.cluster_usage.fill_(1.0)
    return model, cfg


_WAVLM_SMALL = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, conv_dim=[16, 16, 16], conv_kernel=[10, 3, 2],
    conv_stride=[5, 2, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, **_QUIET)
# base (post-norm, GroupNorm extractor) and large (pre-norm, LayerNorm
# extractor, conv biases), as in ``tests/test_wavlm_parity.py``
_WAVLM_FORMS = {
    "base": dict(conv_bias=False, do_stable_layer_norm=False,
                 feat_extract_norm="group"),
    "large": dict(conv_bias=True, do_stable_layer_norm=True,
                  feat_extract_norm="layer", num_hidden_layers=3),
}


def _hf_tower(kind, form, seed=0):
    from transformers import (
        Wav2Vec2Config,
        Wav2Vec2Model,
        WavLMConfig,
        WavLMModel,
    )

    torch.manual_seed(seed)
    kw = {**_WAVLM_SMALL, **_WAVLM_FORMS[form]}
    if kind == "wavlm":
        cfg = WavLMConfig(num_buckets=32, max_bucket_distance=50, **kw)
        return WavLMModel(cfg).eval(), cfg, wavlm_config_from_hf(cfg)
    cfg = Wav2Vec2Config(**kw)
    return Wav2Vec2Model(cfg).eval(), cfg, wav2vec2_config_from_hf(cfg)


_W2VBERT_SMALL = dict(
    hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
    intermediate_size=64, feature_projection_input_dim=20,
    left_max_position_embeddings=8, right_max_position_embeddings=3,
    conv_depthwise_kernel_size=7, conformer_conv_dropout=0.0, **_QUIET)


def _hf_w2vbert():
    from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel

    torch.manual_seed(0)
    cfg = Wav2Vec2BertConfig(**_W2VBERT_SMALL)
    return Wav2Vec2BertModel(cfg).eval(), cfg


def _w2vbert_cfg(hf) -> W2VBertConfig:
    return W2VBertConfig(
        hidden_size=hf.hidden_size, num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        intermediate_size=hf.intermediate_size,
        input_dim=hf.feature_projection_input_dim,
        left_max_positions=hf.left_max_position_embeddings,
        right_max_positions=hf.right_max_position_embeddings,
        conv_kernel=hf.conv_depthwise_kernel_size)


def _loaded(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ----------------------------------------------------------------------- #
# Against the JAX package's converters, bit for bit
# ----------------------------------------------------------------------- #


def _encodec_pair(sd, hf_cfg):
    cfg = encodec_config_from_hf(hf_cfg)
    got = convert_encodec_state_dict(sd, cfg)
    codec = Encodec(cfg.sampling_rate, cfg.sampling_rate,
                    num_codebooks=cfg.num_quantizers, model_config=cfg,
                    state_dict=got, device="cpu")
    tree = jax_encodec.convert_encodec_state_dict(
        sd, jax_encodec.encodec_config_from_hf(hf_cfg))
    return got, from_jax_params(tree, codec)


def _dac_pair(sd, hf_cfg):
    cfg = dac_config_from_hf(hf_cfg)
    got = convert_dac_state_dict(sd, cfg)
    codec = DAC(cfg.sampling_rate, cfg.sampling_rate, model_config=cfg,
                num_codebooks=cfg.n_codebooks, state_dict=got, device="cpu")
    tree = jax_dac.convert_dac_state_dict(sd,
                                          jax_dac.dac_config_from_hf(hf_cfg))
    return got, from_jax_params(tree, codec)


def _mimi_pair(sd, hf_cfg):
    cfg = mimi_config_from_hf(hf_cfg)
    got = convert_mimi_state_dict(sd, cfg)
    codec = Mimi(cfg.sampling_rate, cfg.sampling_rate,
                 num_codebooks=cfg.num_quantizers, model_config=cfg,
                 state_dict=got, device="cpu")
    tree = jax_mimi.convert_mimi_state_dict(sd,
                                            jax_mimi.mimi_config_from_hf(hf_cfg))
    return got, from_jax_params(tree, codec)


def _tower_pair(sd, hf_cfg, kind):
    to_cfg = wavlm_config_from_hf if kind == "wavlm" else \
        wav2vec2_config_from_hf
    jax_to_cfg = jax_wavlm.wavlm_config_from_hf if kind == "wavlm" else \
        jax_wavlm.wav2vec2_config_from_hf
    cfg = to_cfg(hf_cfg)
    got = convert_wavlm_state_dict(sd, cfg)
    tree = jax_wavlm.convert_wavlm_state_dict(sd, jax_to_cfg(hf_cfg))
    return got, from_jax_params(tree, _loaded(WavLM(cfg), got))


def _w2vbert_pair(sd, hf_cfg):
    cfg = _w2vbert_cfg(hf_cfg)
    got = convert_w2vbert_state_dict(sd, num_layers=cfg.num_layers)
    tree = jax_w2vbert.convert_w2vbert_state_dict(sd,
                                                  num_layers=cfg.num_layers)
    return got, from_jax_params(tree, _loaded(W2VBert(cfg), got))


def test_encodec_matches_the_jax_converter_small():
    model, hf_cfg = _hf_encodec()
    got, want = _encodec_pair(model.state_dict(), hf_cfg)
    assert_same_state(got, want, folded=_wn_conv)


def test_dac_matches_the_jax_converter_small():
    model, hf_cfg = _hf_dac()
    got, want = _dac_pair(model.state_dict(), hf_cfg)
    assert_same_state(got, want)


def test_mimi_matches_the_jax_converter_small():
    model, hf_cfg = _hf_mimi()
    got, want = _mimi_pair(model.state_dict(), hf_cfg)
    assert_same_state(got, want, folded=_wn_conv)


@pytest.mark.parametrize("kind,form", [("wavlm", "base"), ("wavlm", "large"),
                                       ("wav2vec2", "large")])
def test_tower_matches_the_jax_converter_small(kind, form):
    model, hf_cfg, _ = _hf_tower(kind, form)
    got, want = _tower_pair(model.state_dict(), hf_cfg, kind)
    assert_same_state(got, want, folded=lambda k: k == "pos_conv.w")


def test_w2vbert_matches_the_jax_converter_small():
    model, hf_cfg = _hf_w2vbert()
    got, want = _w2vbert_pair(model.state_dict(), hf_cfg)
    assert_same_state(got, want)


def _published(name):
    """(HF model class, its published config, the pair function): each at
    its released widths; the transformer towers cut to 2 layers."""
    from transformers import (
        DacConfig,
        DacModel,
        EncodecConfig,
        EncodecModel,
        MimiConfig,
        MimiModel,
        Wav2Vec2BertConfig,
        Wav2Vec2BertModel,
        Wav2Vec2Config,
        Wav2Vec2Model,
        WavLMConfig,
        WavLMModel,
    )

    large = dict(hidden_size=1024, num_attention_heads=16,
                 intermediate_size=4096, conv_bias=True,
                 do_stable_layer_norm=True, feat_extract_norm="layer")
    return {
        # facebook/encodec_24khz
        "encodec_24k": (EncodecModel, EncodecConfig(), _encodec_pair),
        # descript/dac_44khz
        "dac_44k": (DacModel, DacConfig(sampling_rate=44100), _dac_pair),
        # kyutai/mimi
        "mimi": (MimiModel, MimiConfig(num_hidden_layers=2), _mimi_pair),
        # microsoft/wavlm-base-plus and microsoft/wavlm-large
        "wavlm_base": (WavLMModel, WavLMConfig(num_hidden_layers=2),
                       lambda sd, c: _tower_pair(sd, c, "wavlm")),
        "wavlm_large": (WavLMModel,
                        WavLMConfig(num_hidden_layers=2, **large),
                        lambda sd, c: _tower_pair(sd, c, "wavlm")),
        # facebook/wav2vec2-large-xlsr-53
        "wav2vec2_xlsr": (Wav2Vec2Model,
                          Wav2Vec2Config(num_hidden_layers=2, **large),
                          lambda sd, c: _tower_pair(sd, c, "wav2vec2")),
        # facebook/w2v-bert-2.0
        "w2vbert": (Wav2Vec2BertModel,
                    Wav2Vec2BertConfig(num_hidden_layers=2), _w2vbert_pair),
    }[name]


_FOLDED = {"encodec_24k": _wn_conv, "mimi": _wn_conv,
           "wavlm_base": lambda k: k == "pos_conv.w",
           "wavlm_large": lambda k: k == "pos_conv.w",
           "wav2vec2_xlsr": lambda k: k == "pos_conv.w"}


@pytest.mark.parametrize("name", ["encodec_24k", "dac_44k", "mimi",
                                  "wavlm_base", "wavlm_large",
                                  "wav2vec2_xlsr", "w2vbert"])
def test_matches_the_jax_converter_at_the_published_config(name):
    """HF's surface at the released widths, filled by a seeded generator
    (weight-norm gains in [0.5, 1.5]); Mimi's upsample at its published
    512 groups."""
    model_cls, hf_cfg, pair = _published(name)
    sd = synth_state_dict(meta_schema(model_cls, hf_cfg), seed=1)
    got, want = pair(sd, hf_cfg)
    assert_same_state(got, want, folded=_FOLDED.get(name, lambda k: False))
    if name == "mimi":
        # the grouped upsample is the identity map at 512 groups
        assert hf_cfg.upsample_groups == 512
        assert np.array_equal(got["upsample.w"].numpy(),
                              sd["upsample.conv.weight"])


# ----------------------------------------------------------------------- #
# Against the upstream implementation (transformers, random init)
# ----------------------------------------------------------------------- #


def _hf_tokens(model, x, K):
    """HF EnCodec's encoder → its first K RVQ stages → [B, N, K]."""
    with torch.no_grad():
        residual = model.encoder(x[:, None, :])
        codes = []
        for layer in model.quantizer.layers[:K]:
            idx = layer.encode(residual)
            codes.append(idx)
            residual = residual - layer.decode(idx)
        return torch.stack(codes, dim=-1)


@pytest.mark.parametrize("causal,pad_mode", [(True, "reflect"),
                                             (False, "reflect"),
                                             (True, "constant")])
def test_encodec_loaded_gives_the_oracles_tokens(rng, causal, pad_mode):
    model, hf_cfg = _hf_encodec(causal=causal, pad_mode=pad_mode)
    cfg = encodec_config_from_hf(hf_cfg)
    codec = Encodec(800, 800, num_codebooks=3, model_config=cfg,
                    state_dict=convert_encodec_state_dict(
                        model.state_dict(), cfg), device="cpu")
    x = rng.standard_normal((2, 201)).astype(np.float32)
    want = _hf_tokens(model, torch.from_numpy(x), 3)
    assert torch.equal(codec.sig_to_toks(x), want)


def test_encodec_loaded_decodes_as_the_oracle(rng):
    model, hf_cfg = _hf_encodec()
    cfg = encodec_config_from_hf(hf_cfg)
    codec = Encodec(800, 800, num_codebooks=4, model_config=cfg,
                    state_dict=convert_encodec_state_dict(
                        model.state_dict(), cfg), device="cpu")
    toks = rng.integers(0, hf_cfg.codebook_size, size=(2, 25, 4))
    with torch.no_grad():
        q = model.quantizer.decode(torch.from_numpy(toks).movedim(-1, 0))
        want = model.decoder(q).numpy()[:, 0]
    got = codec.toks_to_sig(toks).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    x = rng.standard_normal((2, 160)).astype(np.float32)
    with torch.no_grad():
        want = model.encoder(torch.from_numpy(x)[:, None, :]).numpy()
    np.testing.assert_allclose(codec.sig_to_feats(x).numpy(),
                               want.transpose(0, 2, 1), atol=2e-5, rtol=1e-4)


def test_encodec_24k_published_width_tokens(rng):
    """HF's default ``EncodecConfig`` (facebook/encodec_24khz's
    architecture) at random init, codebooks redrawn N(0, 1): the port's
    tokens equal HF's at B = 1 (torch only)."""
    from transformers import EncodecConfig, EncodecModel

    torch.manual_seed(5)
    model = EncodecModel(EncodecConfig()).eval()
    with torch.no_grad():
        for layer in model.quantizer.layers:
            layer.codebook.embed.normal_()
    cfg = encodec_config_from_hf(model.config)
    codec = Encodec(24000, 24000, num_codebooks=8, model_config=cfg,
                    state_dict=convert_encodec_state_dict(
                        model.state_dict(), cfg), device="cpu")
    x = (0.1 * rng.standard_normal((1, 12000))).astype(np.float32)
    want = _hf_tokens(model, torch.from_numpy(x), 8)
    got = codec.sig_to_toks(x)
    assert got.shape == (1, 38, 8)
    assert torch.equal(got, want)


def test_dac_loaded_gives_the_oracles_tokens_and_decode(rng):
    model, hf_cfg = _hf_dac()
    cfg = dac_config_from_hf(hf_cfg)
    codec = DAC(16000, 16000, num_codebooks=4, model_config=cfg,
                state_dict=convert_dac_state_dict(model.state_dict(), cfg),
                device="cpu")
    x = rng.standard_normal((2, 200)).astype(np.float32)
    with torch.no_grad():
        out = model.encode(torch.from_numpy(x)[:, None, :], n_quantizers=3)
        want_feats = model.encoder(torch.from_numpy(x)[:, None, :]).numpy()
    feats = codec.sig_to_feats(x)
    np.testing.assert_allclose(feats.numpy(), want_feats.transpose(0, 2, 1),
                               atol=2e-5, rtol=1e-4)
    with torch.no_grad():
        toks = dac_rvq_encode(feats, codec.quantizer, 3)
    assert torch.equal(toks, out.audio_codes.transpose(1, 2))
    grid = rng.integers(0, hf_cfg.codebook_size, size=(2, 9, 4))
    with torch.no_grad():
        q = model.quantizer.from_codes(torch.from_numpy(grid).movedim(-1, -2))
        want = model.decoder(q[0]).numpy()[:, 0]
    np.testing.assert_allclose(codec.toks_to_sig(grid).numpy(), want,
                               atol=2e-5, rtol=1e-4)


def test_mimi_loaded_gives_the_oracles_tokens_and_decode(rng):
    model, hf_cfg = _hf_mimi()
    cfg = mimi_config_from_hf(hf_cfg)
    codec = Mimi(512, 512, num_codebooks=3, model_config=cfg,
                 state_dict=convert_mimi_state_dict(model.state_dict(), cfg),
                 device="cpu")
    x = rng.standard_normal((2, 128)).astype(np.float32)
    with torch.no_grad():
        want = model.encode(torch.from_numpy(x)[:, None, :],
                            num_quantizers=3).audio_codes  # [B, K, N]
    assert torch.equal(codec.sig_to_toks(x), want.transpose(1, 2))
    full = Mimi(512, 512, num_codebooks=4, model_config=cfg,
                state_dict=convert_mimi_state_dict(model.state_dict(), cfg),
                device="cpu")
    toks = rng.integers(0, hf_cfg.codebook_size, size=(2, 4, 7))
    with torch.no_grad():
        want = model.decode(torch.from_numpy(toks)).audio_values[:, 0]
    got = full.toks_to_sig(toks.transpose(0, 2, 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-4,
                               rtol=3e-3)


@pytest.mark.parametrize("kind,form", [("wavlm", "base"), ("wavlm", "large"),
                                       ("wav2vec2", "large")])
def test_tower_loaded_gives_the_oracles_hidden_states(rng, kind, form):
    model, hf_cfg, cfg = _hf_tower(kind, form)
    tower = _loaded(WavLM(cfg), convert_wavlm_state_dict(model.state_dict(),
                                                         cfg))
    x = torch.from_numpy(rng.standard_normal((2, 800)).astype(np.float32))
    with torch.no_grad():
        out = model(x, output_hidden_states=True)
        got = apply_wavlm(tower, x, cfg)
        taps = [apply_wavlm(tower, x, cfg, output_layer=i) for i in (1, 2)]
    # tests/test_wavlm_parity.py: base 5e-4/5e-3, the pre-norm forms
    # 3e-5/1e-4
    tol = (dict(atol=5e-4, rtol=5e-3) if form == "base"
           else dict(atol=3e-5, rtol=1e-4))
    np.testing.assert_allclose(got.numpy(), out.last_hidden_state.numpy(),
                               **tol)
    for i, tap in zip((1, 2), taps):
        np.testing.assert_allclose(tap.numpy(),
                                   out.hidden_states[i].numpy(), **tol)


def test_w2vbert_loaded_gives_the_oracles_hidden_states(rng):
    model, hf_cfg = _hf_w2vbert()
    cfg = _w2vbert_cfg(hf_cfg)
    net = _loaded(W2VBert(cfg), convert_w2vbert_state_dict(
        model.state_dict(), num_layers=3))
    feats = torch.from_numpy(
        rng.standard_normal((2, 17, 20)).astype(np.float32))
    with torch.no_grad():
        out = model(feats, output_hidden_states=True)
        for layer in (0, 2, 3):
            got = apply_w2vbert(net, feats, cfg, output_layer=layer)
            np.testing.assert_allclose(got.numpy(),
                                       out.hidden_states[layer].numpy(),
                                       atol=2e-5, rtol=1e-4)


def test_w2vbert_prefix_reads_a_fused_checkpoint():
    """X-Codec 2.0's fused checkpoint holds the tower under
    ``semantic_model.``; its other keys are not read."""
    model, hf_cfg = _hf_w2vbert()
    sd = model.state_dict()
    fused = {f"semantic_model.{k}": v for k, v in sd.items()}
    fused["CodecEnc.conv_blocks.0.bias"] = torch.zeros(4)
    got = convert_w2vbert_state_dict(fused, num_layers=3,
                                     prefix="semantic_model.")
    assert_same_state(got, convert_w2vbert_state_dict(sd, num_layers=3))


# ----------------------------------------------------------------------- #
# Schemas
# ----------------------------------------------------------------------- #


def test_encodec_schema_is_hfs_surface():
    from transformers import EncodecConfig, EncodecModel

    for hf_cfg in (EncodecConfig(), _hf_encodec()[1]):
        assert encodec_schema(encodec_config_from_hf(hf_cfg)) == \
            meta_schema(EncodecModel, hf_cfg)


def test_dac_schema_is_hfs_surface():
    from transformers import DacConfig, DacModel

    published = [DacConfig(sampling_rate=44100),  # descript/dac_44khz
                 DacConfig(sampling_rate=24000, downsampling_ratios=[2, 4, 5, 8],
                           upsampling_ratios=[8, 5, 4, 2], n_codebooks=32),
                 DacConfig(sampling_rate=16000, downsampling_ratios=[2, 4, 5, 8],
                           upsampling_ratios=[8, 5, 4, 2], n_codebooks=12)]
    for hf_cfg in (*published, _hf_dac()[1]):
        assert dac_schema(dac_config_from_hf(hf_cfg)) == \
            meta_schema(DacModel, hf_cfg)


def test_published_dac_configs_are_the_ports_defaults():
    """The three DAC rates' HF configs give the port's
    ``DAC.default_model_config`` architectures."""
    from transformers import DacConfig

    for sr, ratios, n in ((44100, [2, 4, 8, 8], 9), (24000, [2, 4, 5, 8], 32),
                          (16000, [2, 4, 5, 8], 12)):
        hf = DacConfig(sampling_rate=sr, downsampling_ratios=ratios,
                       upsampling_ratios=ratios[::-1], n_codebooks=n)
        assert dac_config_from_hf(hf) == DAC.default_model_config(sr)


# ----------------------------------------------------------------------- #
# Strictness and the weight-norm namings
# ----------------------------------------------------------------------- #


def _legacy_naming(sd: dict) -> dict:
    """``parametrizations.weight.original0/1`` → ``weight_g``/``weight_v``."""
    out = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        out[k.replace("parametrizations.weight.original1", "weight_v")] = v
    return out


def test_both_weight_norm_namings_give_the_same_weights():
    model, hf_cfg = _hf_encodec()
    cfg = encodec_config_from_hf(hf_cfg)
    sd = model.state_dict()
    assert any("original0" in k for k in sd)
    assert_same_state(convert_encodec_state_dict(_legacy_naming(sd), cfg),
                      convert_encodec_state_dict(sd, cfg))
    tower, hf_cfg, cfg = _hf_tower("wavlm", "base")
    sd = tower.state_dict()
    assert_same_state(convert_wavlm_state_dict(_legacy_naming(sd), cfg),
                      convert_wavlm_state_dict(sd, cfg))


def test_weight_norm_fold_is_torchs():
    """The fold of a conv (dim 0) and of a transposed conv's ``[Cin, Cout,
    K]`` weight (dim 0 too) against torch's own ``weight_norm``."""
    from torch.nn.utils.parametrizations import weight_norm

    for conv in (torch.nn.Conv1d(3, 5, 7), torch.nn.ConvTranspose1d(6, 4, 8)):
        conv = weight_norm(conv)
        p = conv.parametrizations.weight
        with torch.no_grad():
            p.original0.uniform_(0.5, 1.5)
            want = conv.weight.numpy()
        np.testing.assert_allclose(
            fold_weight_norm_np(p.original0, p.original1), want, rtol=1e-6,
            atol=1e-7)


@pytest.mark.parametrize("family", ["encodec", "dac", "mimi", "wavlm",
                                    "w2vbert"])
def test_missing_key_raises_and_extra_key_is_ignored_as_upstream(family):
    """The HF converters read what the model needs: a missing key raises
    (in the JAX package's converter too), a key they do not read is
    ignored (the JAX package's converters do not raise on it either)."""
    if family == "encodec":
        model, hf_cfg = _hf_encodec()
        cfg = encodec_config_from_hf(hf_cfg)
        port = lambda sd: convert_encodec_state_dict(sd, cfg)  # noqa: E731
        ref = lambda sd: jax_encodec.convert_encodec_state_dict(  # noqa: E731
            sd, jax_encodec.encodec_config_from_hf(hf_cfg))
        drop = "encoder.layers.7.lstm.bias_hh_l1"
    elif family == "dac":
        model, hf_cfg = _hf_dac()
        cfg = dac_config_from_hf(hf_cfg)
        port = lambda sd: convert_dac_state_dict(sd, cfg)  # noqa: E731
        ref = lambda sd: jax_dac.convert_dac_state_dict(  # noqa: E731
            sd, jax_dac.dac_config_from_hf(hf_cfg))
        drop = "decoder.block.1.res_unit3.snake2.alpha"
    elif family == "mimi":
        model, hf_cfg = _hf_mimi()
        cfg = mimi_config_from_hf(hf_cfg)
        port = lambda sd: convert_mimi_state_dict(sd, cfg)  # noqa: E731
        ref = lambda sd: jax_mimi.convert_mimi_state_dict(  # noqa: E731
            sd, jax_mimi.mimi_config_from_hf(hf_cfg))
        drop = ("quantizer.acoustic_residual_vector_quantizer.layers.2."
                "codebook.cluster_usage")
    elif family == "wavlm":
        model, hf_cfg, cfg = _hf_tower("wavlm", "base")
        port = lambda sd: convert_wavlm_state_dict(sd, cfg)  # noqa: E731
        ref = lambda sd: jax_wavlm.convert_wavlm_state_dict(  # noqa: E731
            sd, jax_wavlm.wavlm_config_from_hf(hf_cfg))
        drop = "encoder.layers.1.attention.gru_rel_pos_const"
    else:
        model, hf_cfg = _hf_w2vbert()
        port = lambda sd: convert_w2vbert_state_dict(  # noqa: E731
            sd, num_layers=3)
        ref = lambda sd: jax_w2vbert.convert_w2vbert_state_dict(  # noqa: E731
            sd, num_layers=3)
        drop = "encoder.layers.2.conv_module.depthwise_conv.weight"
    sd = dict(model.state_dict())
    assert drop in sd
    extra = {**sd, "transform.weight": torch.zeros(4, 4)}
    assert_same_state(port(extra), port(sd))
    ref(extra)
    del sd[drop]
    with pytest.raises(KeyError, match="(?s)" + drop.replace(".", r"\.")):
        port(sd)
    with pytest.raises(KeyError):
        ref(sd)


@pytest.mark.parametrize("family, drop", [
    ("encodec", "decoder.layers.0.conv.bias"),
    ("dac", "decoder.block.0.res_unit1.conv2.bias"),
    ("dac", "decoder.block.1.conv_t1.bias"),
])
def test_missing_conv_bias_raises(family, drop):
    """A conv's bias is read like every other key: a checkpoint without it
    raises, where the JAX package's converters fill in zeros."""
    if family == "encodec":
        model, hf_cfg = _hf_encodec()
        port = lambda sd: convert_encodec_state_dict(  # noqa: E731
            sd, encodec_config_from_hf(hf_cfg))
    else:
        model, hf_cfg = _hf_dac()
        port = lambda sd: convert_dac_state_dict(  # noqa: E731
            sd, dac_config_from_hf(hf_cfg))
    sd = dict(model.state_dict())
    del sd[drop]
    with pytest.raises(KeyError, match=drop.replace(".", r"\.")):
        port(sd)


def test_converted_state_dict_loads_under_every_mode():
    """The codec's mode prunes a converted state dict as it prunes a
    ``from_jax_params`` tree."""
    model, hf_cfg = _hf_encodec()
    cfg = encodec_config_from_hf(hf_cfg)
    sd = convert_encodec_state_dict(model.state_dict(), cfg)
    enc = Encodec(800, 800, mode="encode", model_config=cfg, state_dict=sd,
                  device="cpu")
    dec = Encodec(800, 800, mode="decode", model_config=cfg, state_dict=sd,
                  device="cpu")
    assert not hasattr(enc, "decoder") and not hasattr(dec, "encoder")
