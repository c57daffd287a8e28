"""Port parity: SemantiCodec's modules in ``audiocodecs_tpu_torch`` (AudioMAE,
the LDM UNet, the AutoencoderKL, HiFi-GAN) against the JAX package's on the
same weights (the port's init, carried across by ``to_jax_params`` and
redrawn by ``zoo_pairs.redraw`` so that every leaf moves the output) and
the same numpy inputs, on the CPU.

Small widths at the published structures, each within 1e-4 of the
reference's largest magnitude; then each module once at its published
width on a small input (the port's init as drawn). The reference's layout
is channel-last (a mel ``[B, T, M, 1]``, latents ``[B, h, w, C]``); the
port's is NCHW (``[B, 1, T, M]``) and ``[B, C, T]`` for HiFi-GAN. The
DDIM schedule of the decoder is held bit for bit to the arrays the
reference builds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.nn import audiomae as j_mae
from audiocodecs_tpu.nn import hifigan as j_hifi
from audiocodecs_tpu.nn import ldm_unet as j_unet
from audiocodecs_tpu.nn import ldm_vae as j_vae
from audiocodecs_tpu_torch.models.semanticodec import ddim_schedule
from audiocodecs_tpu_torch.nn import audiomae, hifigan, ldm_unet, ldm_vae
from audiocodecs_tpu_torch.params import from_jax_params, to_jax_params
from zoo_pairs import close, one_thread, redraw  # noqa: F401 (autouse)


def _pair(module, init, seed=0):
    """``module`` with ``init``'s weights (redrawn from ``seed``; as drawn
    with ``seed=None``) and the reference's tree of the same weights."""
    module.load_state_dict(init(torch.Generator().manual_seed(0)))
    tree = to_jax_params(module.state_dict(), module)
    if seed is not None:
        tree = jax.tree.map(np.asarray, redraw(tree, seed))
        module.load_state_dict(from_jax_params(tree, module))
    return module, jax.tree.map(jnp.asarray, tree)


def _x(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _nchw(x):  # the reference's [B, H, W, C] → the port's [B, C, H, W]
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_timestep_embedding(rng):
    """``cat([cos, sin])`` at every DDIM time 1 … 981 of 50 steps, and at
    an odd width (the zero column)."""
    t = np.arange(1, 982, dtype=np.float32)
    for dim in (128, 33):
        want = np.asarray(j_unet.timestep_embedding(jnp.asarray(t), dim))
        got = ldm_unet.timestep_embedding(torch.from_numpy(t), dim)
        close(got, want)


@pytest.mark.parametrize("steps", [1, 2, 3, 50])
def test_ddim_schedule_bit_equal(monkeypatch, steps):
    """The arrays the reference's ``_ldm_ddim`` builds (the arguments of
    its ``jnp.asarray`` calls, recorded while it traces): a_t, a_prev and
    the times, bit for bit, three not dividing 1000 included."""
    import types

    from audiocodecs_tpu.models import semanticodec as ref
    from test_torch_semanticodec import TINY_LDM

    seen = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def asarray(self, a, *args, **kw):
            seen.append((np.array(a), args, kw))
            return jnp.asarray(a, *args, **kw)

    mc = dataclasses.replace(TINY_LDM, ddim_steps=steps)
    params = jax.eval_shape(
        lambda: ref.init_semanticodec_params(jax.random.PRNGKey(0), mc))
    cond = jax.ShapeDtypeStruct((1, mc.tokens_per_window, mc.qfeat_dim),
                                jnp.float32)
    monkeypatch.setattr(ref, "jnp", Recorder())
    jax.eval_shape(lambda p, c: ref.SemantiCodec._ldm_ddim(
        types.SimpleNamespace(model_config=mc), p, c,
        jax.random.PRNGKey(0)), params, cond)
    # the arrays as the reference converts them, outside its trace
    a_t, a_prev, times = (np.asarray(jnp.asarray(a, *args, **kw))
                          for a, args, kw in seen[:3])
    got_times, got_a_t, got_a_prev = ddim_schedule(steps)
    for got, want in ((got_a_t, a_t), (got_a_prev, a_prev),
                      (got_times, times)):
        assert got.dtype == np.float32 and got.shape == (steps,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep_cls", [False, True])
def test_audiomae(rng, keep_cls):
    cfg = audiomae.AudioMAEConfig(mel_frames=32, mel_bins=16, patch_size=4,
                                  hidden_size=32, num_layers=2, num_heads=4)
    jcfg = j_mae.AudioMAEConfig(**dataclasses.asdict(cfg))
    m, tree = _pair(audiomae.AudioMAE(cfg),
                    lambda g: audiomae.init_audiomae_params(g, cfg))
    mel = _x(rng, 2, 32, 16)
    want = np.asarray(j_mae.apply_audiomae(tree, jnp.asarray(mel), jcfg,
                                           keep_cls=keep_cls))
    with torch.no_grad():
        got = audiomae.apply_audiomae(m, torch.from_numpy(mel), cfg,
                                      keep_cls=keep_cls)
    assert want.shape == (2, 32 + keep_cls, 32)
    close(got, want)


# the AUDIOLDM_16K rates and kernels, and WavLM + K-means' (hop 320)
_HIFI = {"audioldm": dict(upsample_rates=(5, 4, 2, 2, 2),
                          upsample_kernel_sizes=(16, 16, 8, 4, 4)),
         "wavlm_kmeans": dict(upsample_rates=(10, 8, 2, 2),
                              upsample_kernel_sizes=(20, 16, 4, 4))}


@pytest.mark.parametrize("rates", sorted(_HIFI))
def test_hifigan(rng, rates):
    """64 initial channels, the three ResBlock1 kernels (3, 7, 11) at
    dilations (1, 3, 5); the odd K − u of the first AudioLDM stage gives
    T·u + 1 samples there."""
    cfg = hifigan.HiFiGANConfig(num_mels=16, upsample_initial_channel=64,
                                **_HIFI[rates])
    jcfg = j_hifi.HiFiGANConfig(**dataclasses.asdict(cfg))
    m, tree = _pair(hifigan.HiFiGAN(cfg),
                    lambda g: hifigan.init_hifigan_params(g, cfg))
    mel = _x(rng, 2, 12, 16)
    want = np.asarray(jax.jit(lambda p, x: j_hifi.apply_hifigan(p, x, jcfg))(
        tree, jnp.asarray(mel)))
    with torch.no_grad():
        got = hifigan.apply_hifigan(
            m, torch.from_numpy(mel).transpose(1, 2), cfg)
    assert want.shape[1] >= 12 * cfg.hop_length
    close(got, want)


_VAE = ldm_vae.VAEConfig(ch=64, ch_mult=(1, 2, 4))


def _vae_pair():
    return _pair(ldm_vae.AutoencoderKL(_VAE),
                 lambda g: ldm_vae.init_vae_params(g, _VAE))


def test_vae_decoder(rng):
    """ch 64, mult (1, 2, 4), two res blocks a level: latents [4, 2, 8] →
    a [16, 8] mel; the middle block's attention over 8 positions."""
    m, tree = _vae_pair()
    jcfg = j_vae.VAEConfig(**dataclasses.asdict(_VAE))
    z = _x(rng, 2, 4, 2, 8)
    want = np.asarray(jax.jit(lambda p, x: j_vae.apply_vae_decoder(
        p, x, jcfg))(tree, jnp.asarray(z)))
    with torch.no_grad():
        got = ldm_vae.apply_vae_decoder(m, _nchw(z), _VAE)
    assert want.shape == (2, 16, 8, 1)
    close(_nhwc(got), want)


def test_vae_encoder(rng):
    """The mirror: a [16, 8] mel → (mean, logvar) on [4, 2], each
    downsample after one row and column of zeros at the bottom right."""
    m, tree = _vae_pair()
    jcfg = j_vae.VAEConfig(**dataclasses.asdict(_VAE))
    mel = _x(rng, 2, 16, 8, 1)
    want = jax.jit(lambda p, x: j_vae.apply_vae_encoder(p, x, jcfg))(
        tree, jnp.asarray(mel))
    with torch.no_grad():
        got = ldm_vae.apply_vae_encoder(m, _nchw(mel), _VAE)
    for g, w in zip(got, want):
        assert w.shape == (2, 4, 2, 8)
        close(_nhwc(g), np.asarray(w))


def test_unet_published_structure(rng):
    """Mults (1, 2, 3, 5), attention at (8, 4, 2), two res blocks a level,
    at 32 channels (one to five heads of 32) on a 32 × 16 latent, a
    context of 6 tokens, t = 981 and 21."""
    cfg = ldm_unet.UNetConfig(model_channels=32, context_dim=24)
    jcfg = j_unet.UNetConfig(**dataclasses.asdict(cfg))
    m, tree = _pair(ldm_unet.UNet(cfg),
                    lambda g: ldm_unet.init_unet_params(g, cfg))
    x, ctx = _x(rng, 2, 32, 16, 8), _x(rng, 2, 6, 24)
    t = np.array([981.0, 21.0], np.float32)
    want = np.asarray(jax.jit(lambda p, a, b, c: j_unet.apply_unet(
        p, a, b, c, jcfg))(tree, x, t, ctx))
    with torch.no_grad():
        got = ldm_unet.apply_unet(m, _nchw(x), torch.from_numpy(t),
                                  torch.from_numpy(ctx), cfg)
    assert want.shape == x.shape
    close(_nhwc(got), want)


def _published(name, rng):
    """(port output, reference output) of ``name`` at its published width
    on a small input, on the port's init as drawn."""
    if name == "unet":  # 128 channels, context 1536, a 16 × 8 latent
        cfg = ldm_unet.UNetConfig(context_dim=1536)
        jcfg = j_unet.UNetConfig(context_dim=1536)
        m, tree = _pair(ldm_unet.UNet(cfg),
                        lambda g: ldm_unet.init_unet_params(g, cfg), None)
        x, ctx = _x(rng, 2, 16, 8, 8), _x(rng, 2, 4, 1536)
        t = np.full((2,), 981.0, np.float32)
        want = jax.jit(lambda p, a, b, c: j_unet.apply_unet(
            p, a, b, c, jcfg))(tree, x, t, ctx)
        got = _nhwc(ldm_unet.apply_unet(m, _nchw(x), torch.from_numpy(t),
                                        torch.from_numpy(ctx), cfg))
    elif name == "vae_decoder":  # ch 128, mult (1, 2, 4), an 8 × 4 latent
        cfg = ldm_vae.AUDIOLDM_VAE
        m, tree = _pair(ldm_vae.AutoencoderKL(cfg),
                        lambda g: ldm_vae.init_vae_params(g, cfg), None)
        z = _x(rng, 1, 8, 4, 8)
        want = jax.jit(lambda p, a: j_vae.apply_vae_decoder(
            p, a, j_vae.AUDIOLDM_VAE))(tree, z)
        got = _nhwc(ldm_vae.apply_vae_decoder(m, _nchw(z), cfg))
    elif name == "audiomae":  # 768 × 12, 12 heads, a 64-frame window
        cfg = audiomae.AudioMAEConfig(mel_frames=64)
        jcfg = j_mae.AudioMAEConfig(mel_frames=64)
        m, tree = _pair(audiomae.AudioMAE(cfg),
                        lambda g: audiomae.init_audiomae_params(g, cfg),
                        None)
        mel = _x(rng, 1, 64, 128)
        want = jax.jit(lambda p, a: j_mae.apply_audiomae(p, a, jcfg))(
            tree, mel)
        got = audiomae.apply_audiomae(m, torch.from_numpy(mel), cfg)
    else:  # HiFi-GAN at 1024 channels over 8 frames
        cfg = hifigan.AUDIOLDM_16K
        m, tree = _pair(hifigan.HiFiGAN(cfg),
                        lambda g: hifigan.init_hifigan_params(g, cfg), None)
        mel = _x(rng, 1, 8, 64)
        want = jax.jit(lambda p, a: j_hifi.apply_hifigan(
            p, a, j_hifi.AUDIOLDM_16K))(tree, mel)
        got = hifigan.apply_hifigan(m, torch.from_numpy(mel).transpose(1, 2),
                                    cfg)
    return got, np.asarray(want)


@pytest.mark.parametrize("name", ["audiomae", "hifigan", "unet",
                                  "vae_decoder"])
def test_published_width(rng, name):
    with torch.no_grad():
        got, want = _published(name, rng)
    assert np.abs(want).max() > 0
    close(got, want)
