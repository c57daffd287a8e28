"""Port parity: ``audiocodecs_tpu_torch`` DAC against the JAX package's on
the same weights (carried over by ``from_jax_params``) and the same numpy
inputs, on the CPU.

Small config (2 ratios, 8 encoder filters, decoder 32 → 8, hidden 16,
4 codebooks of 64 × 8) with weights redrawn so that every layer moves the
output (0.5/√fan_in convs, α = |N| + 0.5, biases ≠ 0): tokens
identical, features, qfeats and waveforms at atol 1e-5 (fp32 sums in
another order). Full published width (44.1 kHz, 9 codebooks, B = 1 × 4410
samples, the reference's own init): features within 1e-4 relative,
token_match ≥ 0.99.

Serving tiers (``audiocodecs_tpu_torch.serving`` against the reference's
``serving.py`` under the same switches): tokens equal to the exact tier's
in both packages. The latency tier ("high" ↦ exact) equals the port's
exact path bit for bit. The fast tier (fp32, one bf16 pass: JAX's is full
fp32 on the CPU, so JAX runs XLA there) lies within 1e-2 · max|sig| of
JAX's exact waveform and off the port's exact path. The throughput tier
(bf16 activations, polynomial snake): the port fuses every decoder unit of
C ≤ 256 at every batch, so JAX runs its fused unit too
(``ACX_PALLAS_DAC_RESUNIT=1``, the Pallas kernel in interpret mode), which
rounds where the port's unit rounds but for h2 (the 1×1 conv's input: the
TPU's one pass rounds it to bf16, JAX's DEFAULT dot on the CPU keeps it
fp32); the port's tier then lies closer to JAX's tier than JAX's tier
lies to its exact path (rms), and moves the waveform by at least a quarter
of JAX's tier's move. The port's decoder with its units unfused is held
the same way to JAX's XLA path (its fused unit off).
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.dac import DAC as JDAC
from audiocodecs_tpu.models.dac import DACModelConfig as JConfig
from audiocodecs_tpu.serving import apply_serving_preset as j_apply
from audiocodecs_tpu_torch.models.dac import (
    DAC,
    DACModelConfig,
    ResidualUnit,
    init_dac_params,
    residual_unit_io,
)
from audiocodecs_tpu_torch.ops.dac_resunit import dac_resunit
from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params
from audiocodecs_tpu_torch.serving import apply_serving_preset

ATOL = 1e-5
SMALL = dict(encoder_hidden_size=8, downsampling_ratios=(2, 2),
             decoder_hidden_size=32, upsampling_ratios=(2, 2), hidden_size=16,
             n_codebooks=4, codebook_size=64, codebook_dim=8)


def _dac_launches() -> int:
    """The DAC unit's kernel launches in this process, every form."""
    return sum(dac_resunit.launches_by_form.values())


def _redraw(tree, seed):
    """Redraw every leaf of the reference's tree (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.tree.map(np.asarray, tree))

    def draw(key, a):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "w":  # [K, Cin, Cout]
            return rng.standard_normal(a.shape) * 0.5 / np.sqrt(
                a.shape[0] * a.shape[1])
        if leaf.startswith("alpha"):
            return np.abs(rng.standard_normal(a.shape)) + 0.5
        return rng.standard_normal(a.shape) * (0.1 if leaf == "b" else 1.0)

    new = {k: jnp.asarray(draw(k, a), jnp.float32) for k, a in flat.items()}

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, f"{prefix}.{i}") for i, v in enumerate(node)]
        return new[prefix]

    return rebuild(tree, "")


def _pair(mode="reconstruct", sample_rate=16000, num_codebooks=4,
          latent=False, seed=0):
    jcfg = JConfig(**SMALL)
    params = _redraw(JDAC(16000, 16000, model_config=jcfg).params, seed)
    jc = JDAC(sample_rate, 16000, mode=mode, num_codebooks=num_codebooks,
              latent=latent, model_config=jcfg, params=params)
    tc = DAC(sample_rate, 16000, mode=mode, num_codebooks=num_codebooks,
             latent=latent,
             model_config=DACModelConfig(**dataclasses.asdict(jcfg)),
             device="cpu")
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def small_pair():
    return _pair()


def _sig(rng, B, T, scale=0.3):
    return (rng.standard_normal((B, T)) * scale).astype(np.float32)


@pytest.mark.parametrize("B,T", [(2, 2000), (1, 1999), (3, 301), (1, 4)])
def test_tokens_identical_and_features_close(small_pair, rng, B, T):
    jc, tc = small_pair
    sig = _sig(rng, B, T)
    j_toks = np.asarray(jc.sig_to_toks(sig))
    t_toks = tc.sig_to_toks(sig).numpy()
    assert t_toks.shape == j_toks.shape
    np.testing.assert_array_equal(t_toks, j_toks)
    jf = np.asarray(jc.sig_to_feats(sig))
    assert np.abs(jf).max() > 0.1  # the redrawn weights reach the output
    np.testing.assert_allclose(tc.sig_to_feats(sig).numpy(), jf, atol=ATOL)
    np.testing.assert_allclose(tc.sig_to_qfeats(sig).numpy(),
                               np.asarray(jc.sig_to_qfeats(sig)), atol=ATOL)


@pytest.mark.parametrize("N", [1, 37, 250])
def test_decode_close_on_same_tokens(small_pair, rng, N):
    jc, tc = small_pair
    toks = rng.integers(0, 64, (2, N, 4)).astype(np.int32)
    want = np.asarray(jc.toks_to_sig(toks))
    assert want.shape == (2, 4 * N) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(tc.toks_to_sig(toks).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tc.toks_to_qfeats(toks).numpy(),
                               np.asarray(jc.toks_to_qfeats(toks)), atol=ATOL)
    feats = rng.standard_normal((2, N, 16)).astype(np.float32)
    np.testing.assert_allclose(tc.feats_to_sig(feats).numpy(),
                               np.asarray(jc.feats_to_sig(feats)), atol=ATOL)


def test_reconstruct_roundtrip_and_logits(small_pair, rng):
    jc, tc = small_pair
    sig = _sig(rng, 2, 1600)
    want = np.asarray(jc(sig))
    np.testing.assert_allclose(tc(sig).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tc.roundtrip(sig).numpy(), want, atol=ATOL)
    jl, tl = np.asarray(jc.logits()), tc.logits().numpy()
    assert tl.shape == jl.shape == (4, 64, 64)
    np.testing.assert_array_equal(np.isinf(tl), np.isinf(jl))
    finite = np.isfinite(jl)
    np.testing.assert_allclose(tl[finite], jl[finite], atol=1e-4)


@pytest.mark.parametrize("latent", [False, True])
def test_latent_flag_feats_and_embs(rng, latent):
    jc, tc = _pair(latent=latent, seed=1)
    sig = _sig(rng, 2, 900)
    jf = np.asarray(jc.sig_to_feats(sig))
    assert jf.shape == (2, 225, 8 if latent else 16)
    np.testing.assert_allclose(tc.sig_to_feats(sig).numpy(), jf, atol=ATOL)
    je, te = np.asarray(jc.embs()), tc.embs().numpy()
    assert te.shape == je.shape == ((4, 64, 8) if latent else (4, 64, 16))
    np.testing.assert_allclose(te, je, atol=ATOL)


def test_other_input_rate_matches(rng):
    """24 kHz in and out: resampling composes around the 16 kHz model."""
    jc, tc = _pair(sample_rate=24000, seed=2)
    sig = _sig(rng, 2, 1500)
    np.testing.assert_array_equal(tc.sig_to_toks(sig).numpy(),
                                  np.asarray(jc.sig_to_toks(sig)))
    np.testing.assert_allclose(tc.roundtrip(sig).numpy(), np.asarray(jc(sig)),
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_modes_prune_and_load_strict(rng, mode):
    jc, tc = _pair(mode=mode, seed=3)
    keys = set(tc.state_dict())
    assert set(flatten_tree(jax.tree.map(np.asarray, jc.params))) == keys
    assert (mode == "encode") == (not any(k.startswith("decoder.")
                                          for k in keys))
    assert (mode == "decode") == (not any(k.startswith("encoder.")
                                          for k in keys))
    if mode == "encode":
        sig = _sig(rng, 1, 640)
        np.testing.assert_array_equal(tc(sig).numpy(), np.asarray(jc(sig)))
    else:
        toks = rng.integers(0, 64, (1, 12, 4)).astype(np.int32)
        np.testing.assert_allclose(tc(toks).numpy(), np.asarray(jc(toks)),
                                   atol=ATOL)


def test_bridge_layouts_and_strictness():
    jc, tc = _pair(seed=4)
    tree = jax.tree.map(np.asarray, jc.params)
    sd = from_jax_params(tree, tc)
    np.testing.assert_array_equal(
        sd["encoder.blocks.0.res.1.conv1.w"].numpy(),
        tree["encoder"]["blocks"][0]["res"][1]["conv1"]["w"].transpose(2, 1,
                                                                       0))
    # pre-flipped transposed conv → PyTorch's [Cin, Cout, K]
    np.testing.assert_array_equal(
        sd["decoder.blocks.1.convtr.w"].numpy(),
        np.flip(tree["decoder"]["blocks"][1]["convtr"]["w"], 0).transpose(
            1, 2, 0))
    np.testing.assert_array_equal(sd["quantizer.3.codebook"].numpy(),
                                  tree["quantizer"][3]["codebook"])
    np.testing.assert_array_equal(sd["encoder.blocks.1.alpha_down"].numpy(),
                                  tree["encoder"]["blocks"][1]["alpha_down"])
    del tree["decoder"]["blocks"][0]["res"][2]["alpha2"]
    with pytest.raises(KeyError):
        from_jax_params(tree, tc)


def test_init_is_seeded_and_complete():
    mc = DACModelConfig(**SMALL)
    a = init_dac_params(torch.Generator().manual_seed(5), mc)
    b = init_dac_params(torch.Generator().manual_seed(5), mc)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["decoder.blocks.0.res.0.conv1.w"].std()) == pytest.approx(
        0.02, rel=0.1)
    assert not a["encoder.conv_in.b"].any()
    assert (a["encoder.alpha_out"] == 1).all()
    tc = DAC(16000, num_codebooks=4, model_config=mc, state_dict=a,
             device="cpu")
    assert tc.embs().shape == (4, 64, 16)


@pytest.mark.parametrize("rate", [16000, 24000, 44100])
def test_default_model_config_matches_reference(rate):
    want = dataclasses.asdict(JDAC.default_model_config(rate))
    assert dataclasses.asdict(DAC.default_model_config(rate)) == want


@pytest.fixture(scope="module")
def full_pair():
    """The published 44.1 kHz config, the reference's init from one key."""
    jc = JDAC(44100, 44100, num_codebooks=9, key=jax.random.PRNGKey(0))
    tc = DAC(44100, 44100, num_codebooks=9, device="cpu")
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


def test_kernel_gate_is_decoder_units_up_to_256_channels(full_pair):
    _, tc = full_pair
    units = {n: m for n, m in tc.named_modules()
             if isinstance(m, ResidualUnit)}
    assert len(units) == 24
    fused = sorted((n, m.conv1.w.shape[0]) for n, m in units.items()
                   if m.fused)
    assert [c for _, c in fused] == [192] * 3 + [96] * 3
    assert all(n.startswith("decoder.blocks.") for n, _ in fused)
    assert {m.conv1.w.shape[0] for m in units.values() if not m.fused} == {
        64, 128, 256, 512, 768, 384}


def test_full_width_features_tokens_and_shapes(full_pair, rng):
    jc, tc = full_pair
    sig = _sig(rng, 1, 4410, scale=0.1)
    jf = np.asarray(jc.sig_to_feats(sig))
    tf = tc.sig_to_feats(sig).numpy()
    assert tf.shape == jf.shape == (1, 8, 1024)
    assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 8, 9)
    assert (tt == jt).mean() >= 0.99
    before = _dac_launches()
    y = tc.toks_to_sig(tt).numpy()
    assert _dac_launches() == before  # CPU tensors: the plain version
    want = np.asarray(jc.toks_to_sig(tt))
    assert y.shape == want.shape == (1, 4096)
    assert np.abs(y - want).max() <= 1e-4 * np.abs(want).max()


_KNOBS = ("ACX_ACT_DTYPE", "ACX_CONV_PRECISION", "ACX_DEC_CONV_PRECISION",
          "ACX_SNAKE_APPROX", "ACX_PALLAS_DAC_RESUNIT",
          "ACX_PALLAS_LSTM_WIDE")


@contextlib.contextmanager
def reference_tier(family, quality, batch, fused=False):
    """The reference's switches for a tier inside ``with``, its fused unit
    on (the Pallas kernel in interpret mode) where ``fused``, else off (XLA
    on the CPU); the environment and the kernel are put back after it."""
    from audiocodecs_tpu.ops import dac_resunit_pallas as pallas

    saved = {k: os.environ.pop(k, None) for k in _KNOBS}
    kernel = pallas.dac_resunit_pallas
    try:
        env = j_apply(family, quality, batch)
        if fused:
            os.environ["ACX_PALLAS_DAC_RESUNIT"] = "1"

            def interpreted(x, w7, b7, alpha1, w1, b1, alpha2, **kw):
                # BigCodec holds its α as [1, 1, C]; the kernel takes [C]
                return kernel(x, w7, b7, alpha1.reshape(-1), w1, b1,
                              alpha2.reshape(-1), interpret=True, **kw)

            pallas.dac_resunit_pallas = interpreted
        else:
            os.environ.pop("ACX_PALLAS_DAC_RESUNIT", None)
        yield env
    finally:
        pallas.dac_resunit_pallas = kernel
        for k in _KNOBS:
            os.environ.pop(k, None)
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def check_bf16_tier(t_tier, t_exact, j_tier, j_exact):
    """A bf16-activation tier's waveform against the reference's computed
    the same way (see the module's docstring)."""
    j_move = rms(j_tier - j_exact)
    assert j_move > 0
    assert rms(t_tier - j_tier) < j_move
    assert rms(t_tier - t_exact) >= 0.25 * j_move


def unfused(codec):
    """The same codec with every residual unit on the unfused path."""
    for m in codec.modules():
        if isinstance(m, ResidualUnit):
            m.fused = False
    return codec


@pytest.mark.parametrize("quality,batch", [("balanced", None),
                                           ("fast", None), ("balanced", 4),
                                           ("balanced", 8)])
def test_serving_tiers_match_the_reference(small_pair, rng, quality, batch):
    jc, tc = small_pair
    sig = _sig(rng, 2, 2000)
    toks = np.asarray(jc.sig_to_toks(sig))
    j_exact = np.asarray(jc.toks_to_sig(toks))
    t_exact = tc.toks_to_sig(toks).numpy()
    kw = apply_serving_preset("dac", quality, batch)
    bf16 = kw["decode_dtype"] == torch.bfloat16

    def port():
        return DAC(16000, 16000, num_codebooks=4,
                   model_config=tc.model_config, state_dict=tc.state_dict(),
                   device="cpu", **kw)

    def reference(fused):
        with reference_tier("dac", quality, batch, fused):
            jt = JDAC(16000, 16000, num_codebooks=4,
                      model_config=jc.model_config,
                      params=jc.params)  # a new instance: a fresh trace
            np.testing.assert_array_equal(np.asarray(jt.sig_to_toks(sig)),
                                          toks)
            return np.asarray(jt.toks_to_sig(toks))

    tt = port()
    np.testing.assert_array_equal(tt.sig_to_toks(sig).numpy(), toks)
    t_tier = tt.toks_to_sig(toks).numpy()
    assert t_tier.dtype == np.float32 and t_tier.shape == j_exact.shape
    if bf16:
        check_bf16_tier(t_tier, t_exact, reference(True), j_exact)
        check_bf16_tier(unfused(port()).toks_to_sig(toks).numpy(), t_exact,
                        reference(False), j_exact)
    elif kw["decode_precision"] == "exact":
        reference(False)
        np.testing.assert_array_equal(t_tier, t_exact)
    else:
        reference(False)
        assert np.abs(t_tier - j_exact).max() <= 1e-2 * np.abs(j_exact).max()
        assert not np.array_equal(t_tier, t_exact)


def test_decode_form_convs_and_their_cached_weights(rng):
    """A form's convs: exact is ``conv1d`` itself; fp32 "default" convolves
    bf16-rounded operands in fp32 and adds the fp32 bias; bf16 rounds the
    conv's output, then adds the bf16 bias. The cast weights are built once
    and again after ``load_state_dict`` writes new ones."""
    import torch.nn.functional as F

    from audiocodecs_tpu_torch.models.dac import DecodeForm
    from audiocodecs_tpu_torch.nn.layers import Conv1d

    conv = Conv1d(6, 4, 3)
    new = {"w": torch.from_numpy(rng.standard_normal((4, 6, 3)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(4).astype(
            np.float32))}
    conv.load_state_dict(new)
    x = torch.from_numpy(rng.standard_normal((2, 6, 50)).astype(np.float32))
    bf = torch.bfloat16
    with torch.no_grad():
        exact = DecodeForm().conv1d(x, conv, pad=1)
        torch.testing.assert_close(
            exact, F.conv1d(F.pad(x, (1, 1)), conv.w, conv.b), rtol=0,
            atol=0)
        one_pass = DecodeForm(precision="default").conv1d(x, conv, pad=1)
        want = F.conv1d(F.pad(x, (1, 1)).to(bf).float(),
                        conv.w.to(bf).float(), conv.b)
        torch.testing.assert_close(one_pass, want, rtol=0, atol=0)
        assert not torch.equal(one_pass, exact)
        form = DecodeForm(bf, "default")
        got = form.conv1d(x.to(bf), conv, pad=1)
        want = (F.conv1d(F.pad(x, (1, 1)).to(bf), conv.w.to(bf))
                + conv.b.to(bf)[:, None])
        assert got.dtype == bf and torch.equal(got, want)
        w = form.param(conv, "w")
        assert form.param(conv, "w") is w  # cast once
        conv.load_state_dict({k: v + 1 for k, v in new.items()})
        w2 = form.param(conv, "w")
        assert w2 is not w and torch.equal(w2, (new["w"] + 1).to(bf))


def test_residual_unit_io_feeds_a_unit_its_own_input(small_pair, rng):
    """``residual_unit_io`` yields every decoder unit's input and output of
    the decodes run inside it; the unit fed that input again gives that
    output, and no hook outlives the ``with``."""
    _, tc = small_pair
    toks = tc.sig_to_toks(_sig(rng, 1, 2000))
    units = {n: m for n, m in tc.decoder.named_modules()
             if isinstance(m, ResidualUnit)}
    with residual_unit_io(tc.decoder) as (ins, outs):
        tc.toks_to_sig(toks)
    assert sorted(ins) == sorted(outs) == sorted(units) and len(units) == 6
    with torch.inference_mode():
        for name, unit in units.items():
            assert torch.equal(unit(ins[name]), outs[name])
    assert all(not m._forward_hooks for m in units.values())
