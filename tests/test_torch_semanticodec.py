"""Port parity: SemantiCodec of ``audiocodecs_tpu_torch`` against the JAX
package's on the same weights (the port's init carried across by
``to_jax_params`` and redrawn by ``zoo_pairs.redraw``) and the same numpy
inputs, on the CPU.

The small ``"ldm"`` config of ``tests/test_ldm_decoder.py`` and the
``"analog"`` config of ``tests/test_codec_zoo4.py``: tokens identical,
qfeats exact, the decode of tokens and of features within 1e-4 of the
reference's largest magnitude given the reference's own start noise
(``jax.random.normal(PRNGKey(0), …)`` passed as ``noise``; the port draws
its own from a seeded torch generator otherwise); an input of several
windows (the crossfade); the constructor's arguments, the modes, the
embeddings and the bridge back. The bf16 tier is held to the reference's
under ``ACX_ACT_DTYPE=decoder-bfloat16`` as the bf16 tiers of DAC are
(``test_torch_dac.check_bf16_tier``: closer to it than the reference's own
move off exact, and moved at least a quarter as far).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.semanticodec import SemantiCodec as JSemantiCodec
from audiocodecs_tpu.models.semanticodec import (
    SemantiCodecModelConfig as JConfig,
)
from audiocodecs_tpu.nn.hifigan import HiFiGANConfig as JHiFiGANConfig
from audiocodecs_tpu.nn.ldm_vae import VAEConfig as JVAEConfig
from audiocodecs_tpu_torch.models.semanticodec import (
    SemantiCodec,
    SemantiCodecModelConfig,
    init_semanticodec_params,
)
from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode
from audiocodecs_tpu_torch.serving import apply_serving_preset
from test_torch_dac import check_bf16_tier
from zoo_pairs import (
    check_bridge,
    check_modes,
    close,
    one_thread,  # noqa: F401 (autouse)
    pair,
    port_config,
)

# tests/test_ldm_decoder.py::tiny_ldm_codec_config
TINY_LDM = JConfig(
    mel_bins=16, window_frames=32, patch_size=16,
    vit_hidden=32, vit_layers=1, vit_heads=2,
    semantic_vocab=16, acoustic_vocab=16,
    ddim_steps=2, decoder_variant="ldm", ldm_mel_bins=16,
    vae_cfg=JVAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                       z_channels=4, embed_dim=4),
    unet_channels=32, unet_channel_mult=(1, 2), unet_num_res_blocks=1,
    unet_attention_resolutions=(2,), unet_head_channels=16,
    vocoder_cfg=JHiFiGANConfig(
        num_mels=16, upsample_rates=(5, 4, 2, 2, 2),
        upsample_kernel_sizes=(16, 16, 8, 4, 4),
        upsample_initial_channel=64,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),)))
# patches of 4: 32 tokens a window, an overlap of 2 tokens (320 samples)
TINY_LDM_LONG = dataclasses.replace(TINY_LDM, patch_size=4)
# tests/test_codec_zoo4.py::test_semanticodec_contract
TINY_ANALOG = JConfig(
    mel_bins=16, window_frames=32, patch_size=4, vit_hidden=16,
    vit_layers=1, vit_heads=2, stack_factor=2, semantic_vocab=32,
    acoustic_vocab=16, denoiser_hidden=16, denoiser_layers=1,
    denoiser_heads=2, ddim_steps=2, decoder_variant="analog")
SR = 16000


def _sig(rng, B, T):
    return (rng.standard_normal((B, T)) * 0.5).astype(np.float32)


def _pair(jcfg, seed=0, **kw):
    return pair(JSemantiCodec, SemantiCodec, SemantiCodecModelConfig, jcfg,
                SR, seed=seed, **kw)


def _noise(tc, n_windows):
    """The reference's start noise for ``n_windows`` windows: its draw
    from ``PRNGKey(0)`` in its (B', Tl, Fl, C) or (B', N, H) order."""
    mc = tc.model_config
    if mc.decoder_variant == "ldm":
        ds = mc.vae_cfg.downsample_factor
        shape = (n_windows, mc.window_frames // ds, mc.ldm_mel_bins // ds,
                 mc.vae_cfg.embed_dim)
    else:
        shape = (n_windows, mc.tokens_per_window, mc.denoiser_hidden)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape))


def _n_windows(mc, n_tokens):
    Wt = mc.tokens_per_window
    step = max(1, Wt - int(round(Wt * mc.segment_overlap_ratio)))
    return 1 if n_tokens <= Wt else -(-(n_tokens - Wt) // step) + 1


def _decode(tc, cond, noise):
    with torch.inference_mode():
        return tc._windows_to_sig(torch.as_tensor(cond), noise).numpy()


def _reference(jc, sig):
    """The reference's features, tokens, qfeats and both decodes of
    ``sig``, traced as one program."""

    def run(params, x):
        feats = jc._sig_to_feats(params, x, None)
        toks = jc._sig_to_toks(params, x, None)
        return {"feats": feats, "toks": toks,
                "qfeats": jc._toks_to_qfeats(params, toks, None),
                "sig": jc._toks_to_sig(params, toks, None),
                "feats_sig": jc._feats_to_sig(params, feats, None)}

    out = jax.jit(run)(jc.params, jnp.asarray(sig))
    return {k: np.asarray(v) for k, v in out.items()}


def _check(jc, tc, sig):
    """Tokens identical, features within 1e-4, qfeats exact, the decode of
    the tokens and of the features within 1e-4 of max|sig| given the
    reference's noise."""
    want = _reference(jc, sig)
    toks = tc.sig_to_toks(sig)
    np.testing.assert_array_equal(toks.numpy(), want["toks"])
    close(tc.sig_to_feats(sig), want["feats"])
    q = tc.toks_to_qfeats(want["toks"])
    np.testing.assert_array_equal(q.numpy(), want["qfeats"])
    np.testing.assert_array_equal(tc.sig_to_qfeats(sig).numpy(),
                                  want["qfeats"])
    B, N = want["toks"].shape[:2]
    noise = _noise(tc, B * _n_windows(tc.model_config, N))
    close(_decode(tc, q, noise), want["sig"])
    with torch.inference_mode():  # _feats_to_sig's conditioning
        feats, cb = torch.as_tensor(want["feats"]), tc.semantic_codebook
        sem = vq_decode(vq_encode(feats, cb), cb)
    close(_decode(tc, torch.cat([feats - sem, sem], -1), noise),
          want["feats_sig"])
    return want


@pytest.fixture(scope="module")
def ldm():
    return _pair(TINY_LDM)


def test_ldm_tokens_identical_decode_close(ldm, rng):
    """Two rows of 0.2 s (one window), then the bridge, the modes and the
    embeddings."""
    jc, tc = ldm
    want = _check(jc, tc, _sig(rng, 2, 3200))
    assert want["toks"].shape == (2, 2, 2)
    assert want["sig"].shape == (2, 2 * 16 * 160)
    check_bridge(jc, tc)
    check_modes(JSemantiCodec, SemantiCodec, tc, (jc.model_config,
                                                  jc.params), SR)
    close(tc.embs(), np.asarray(jc.embs()))


def test_ldm_several_windows_crossfade(rng):
    """0.7 s at 32 tokens a window: 72 tokens in three windows that
    overlap by 2 tokens (320 samples of linear ramps), the last padded
    with −1."""
    jc, tc = _pair(TINY_LDM_LONG)
    mc = tc.model_config
    assert mc.tokens_per_window == 32
    want = _check(jc, tc, _sig(rng, 1, 11200))
    assert want["toks"].shape == (1, 72, 2)
    assert _n_windows(mc, 72) == 3
    assert want["sig"].shape == (1, 72 * 160)


def test_ldm_own_noise_is_seeded_and_device_free(ldm, rng):
    """Without ``noise`` the port starts from its seeded CPU draw: two
    decodes are equal, and equal to the decode given that draw."""
    _, tc = ldm
    toks = tc.sig_to_toks(_sig(rng, 2, 3200))
    y = tc.toks_to_sig(toks)
    assert torch.equal(y, tc.toks_to_sig(toks))
    mc = tc.model_config
    shape = (2, mc.window_frames // 2, mc.ldm_mel_bins // 2, 4)
    own = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        _decode(tc, tc.toks_to_qfeats(toks), own.numpy()), y.numpy())


def test_analog_tokens_identical_decode_close(rng):
    """The transformer denoiser and Vocos head: 0.5 s at stack factor 2,
    26 tokens of 16 a window (the crossfade over one token)."""
    jc, tc = _pair(TINY_ANALOG)
    want = _check(jc, tc, _sig(rng, 2, 8000))
    assert want["toks"].shape == (2, 26, 2)
    check_bridge(jc, tc)
    check_modes(JSemantiCodec, SemantiCodec, tc, (jc.model_config,
                                                  jc.params), SR)
    assert tc.embs().shape == (2, 32, 32)


def test_constructor_arguments():
    """``token_rate`` → the stack factor, the semantic vocab, the DDIM
    steps and the guidance scale, as the reference's constructor maps
    them; two codebooks only."""
    cfg = port_config(SemantiCodecModelConfig, TINY_ANALOG)
    for rate, sf in ((100, 1), (50, 2), (25, 4)):
        kw = {"token_rate": rate, "semantic_vocab_size": 24,
              "ddim_sample_step": 3, "cfg_scale": 1.5}
        tc = SemantiCodec(SR, model_config=cfg, device="cpu", **kw)
        jmc = JSemantiCodec(SR, model_config=TINY_ANALOG, params={},
                            mode="encode", **kw).model_config
        assert dataclasses.asdict(tc.model_config) == dataclasses.asdict(jmc)
        assert tc.model_config.stack_factor == sf
        assert tc.config.vocab_sizes == (24, 16)
        assert tc.embs().shape == (2, 24, 16 * sf)
        assert tc.semantic_codebook.shape == (24, 16 * sf)
    with pytest.raises(ValueError, match="token_rate"):
        SemantiCodec(SR, model_config=cfg, device="cpu", token_rate=75)
    with pytest.raises(ValueError, match="2 codebooks"):
        SemantiCodec(SR, model_config=cfg, device="cpu", num_codebooks=3)


@pytest.mark.parametrize("cfg", [TINY_LDM, TINY_ANALOG],
                         ids=["ldm", "analog"])
def test_init_is_seeded_and_complete(cfg):
    pcfg = port_config(SemantiCodecModelConfig, cfg)
    a = init_semanticodec_params(torch.Generator().manual_seed(3), pcfg)
    b = init_semanticodec_params(torch.Generator().manual_seed(3), pcfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    tc = SemantiCodec(SR, model_config=pcfg, device="cpu", state_dict=a)
    assert sorted(tc.state_dict()) == sorted(a)


def test_bf16_tier_matches_the_reference(ldm, rng, monkeypatch):
    """The balanced tier (bf16 UNet, VAE and vocoder) against the
    reference's under ``ACX_ACT_DTYPE=decoder-bfloat16`` on the same
    tokens and noise (``check_bf16_tier``); tokens equal to the exact
    tier's."""
    jc, tc = ldm
    sig = _sig(rng, 2, 3200)
    toks = tc.sig_to_toks(sig)
    q = tc.toks_to_qfeats(toks)
    noise = _noise(tc, 2)
    j_decode = jax.jit(lambda p, t: jc._toks_to_sig(p, t, None))
    j_exact = np.asarray(j_decode(jc.params, toks.numpy()))
    kw = apply_serving_preset("semanticodec")
    assert kw == {"decode_dtype": torch.bfloat16,
                  "decode_precision": "default"}
    monkeypatch.setenv("ACX_ACT_DTYPE", "decoder-bfloat16")
    jt = JSemantiCodec(SR, SR, model_config=jc.model_config,
                       params=jc.params)
    j_tier = np.asarray(jax.jit(lambda p, t: jt._toks_to_sig(p, t, None))(
        jt.params, toks.numpy()))
    np.testing.assert_array_equal(np.asarray(jt.sig_to_toks(sig)),
                                  toks.numpy())
    tier = SemantiCodec(SR, model_config=tc.model_config, device="cpu",
                        state_dict=tc.state_dict(), **kw)
    assert torch.equal(tier.sig_to_toks(sig), toks)
    t_tier = _decode(tier, q, noise)
    assert t_tier.dtype == np.float32 and np.isfinite(t_tier).all()
    check_bf16_tier(t_tier, _decode(tc, q, noise), j_tier, j_exact)


def test_fp32_default_precision_decodes_exactly(ldm, rng):
    """``decode_precision="default"`` at fp32 activations is the exact
    decode bit for bit: the reference opens no decoder scope for
    SemantiCodec."""
    _, tc = ldm
    toks = tc.sig_to_toks(_sig(rng, 1, 3200))
    one = SemantiCodec(SR, model_config=tc.model_config, device="cpu",
                       state_dict=tc.state_dict(),
                       decode_precision="default")
    assert torch.equal(one.toks_to_sig(toks), tc.toks_to_sig(toks))
