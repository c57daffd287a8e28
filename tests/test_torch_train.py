"""Port parity for codec training: ``audiocodecs_tpu_torch.parallel.train``
against ``audiocodecs_tpu/parallel/train.py`` on the same weights (carried
over by ``from_jax_params``) and the same numpy batches, on the CPU, at the
tiny EnCodec of ``tests/test_codec_training.py`` (8 filters, ratios (4, 2),
LSTM H = 32, 2 codebooks of 64 × 16, 800 Hz).

``codec_loss`` and the train steps are held in float64 on both sides (the
port's CPU path is dtype-generic; the JAX package runs under
``jax.enable_x64`` with its SEANet's float32 islands made float64, see
``jax_f64``), and again in float32. Tolerances:

* losses and metrics: 1e-5 relative (sums in another order);
* gradients: 1e-4 · max|g| + 1e-7 a leaf, in float64 with or without the
  spectral term, and in float32 without it;
* gradients in float32 with the spectral term: 5e-2 · max|g|. The term is
  ill-conditioned at this size: its log-magnitude part has gradient
  1/(|S| + 1e-5), and where |S| falls to a few 1e-4 moving the
  reconstruction by its float32 rounding moves dL/drec by tenths of a
  percent to percents of its max, in float64 already. Which of those moves
  a float32 run gets depends on where its rounding lands (the
  straight-through ``feats + (q - feats)`` alone moves it), so either
  package in float32 is off the float64 gradient by 1e-3 to 1e-2 · max|g|
  (``tools/spectral_grad_conditioning.py`` measures this); the spectral
  loss's own gradient is held in float64 (1e-9);
* train steps: metrics 1e-4 relative in float64; in float32 the same while
  the parameters have taken no update through the spectral gradient, 1e-2
  after one (the rounding above, amplified by Adam's sign-like first
  updates);
* the EMA codebook update on the JAX package's restart rows: 1e-6.

The train steps' cases are in ``tests/test_torch_train_steps.py`` (two
pytest workers share the two files); the helpers in
``tests/train_pairs.py``.
"""

import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.metrics import dsp as jdsp
from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.parallel import train as jtrain
from audiocodecs_tpu.quant.rvq import rvq_quantize as j_rvq_quantize
from audiocodecs_tpu.utils import audio as jaudio
from audiocodecs_tpu.utils.checkpoint import load_params as j_load_params
from audiocodecs_tpu_torch.downstream.metrics import dsp
from audiocodecs_tpu_torch.examples import train_codec
from audiocodecs_tpu_torch.parallel import train
from audiocodecs_tpu_torch.params import from_jax_params, to_jax_params
from audiocodecs_tpu_torch.quant.rvq import rvq_quantize, rvq_quantize_stats
from audiocodecs_tpu_torch.utils.audio import (
    example_signal,
    read_wav,
    write_wav,
)
from audiocodecs_tpu_torch.utils.checkpoint import load_params, save_params
from train_pairs import (  # noqa: F401 (jax_f64: a fixture _in_dtype asks for)
    K,
    SR,
    _batch,
    _in_dtype,
    _jax_rows,
    _port,
    _rel,
    jax_codec,
    jax_f64,
    tiny_cfg,
)
from zoo_pairs import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("spec_weight", [0.0, 0.5])
@pytest.mark.parametrize("ema", [False, True])
def test_codec_loss_and_gradients_match_jax(jax_codec, request, ema,
                                            spec_weight, dtype):
    j_params, tc = _in_dtype(request, jax_codec, dtype)
    sig = _batch(0).astype(dtype)
    fn = jax.jit(jax.value_and_grad(
        lambda p, s: jtrain.codec_loss(p, s, tiny_cfg(), K,
                                       spec_weight=spec_weight, ema=ema),
        has_aux=True))
    (j_loss, j_aux), j_grads = fn(j_params, sig)
    loss, aux = train.codec_loss(tc, sig, K, spec_weight=spec_weight,
                                 ema=ema)
    assert loss.dtype == getattr(torch, dtype)
    assert np.asarray(j_loss).dtype == dtype
    loss.backward()
    j_met, met = (j_aux[0], aux[0]) if ema else (j_aux, aux)
    assert sorted(met) == sorted(j_met)
    assert ("spec" in met) == (spec_weight > 0)
    assert ("codebook" in met) == (not ema)
    assert _rel(loss, j_loss) <= 1e-5
    for k in j_met:
        assert _rel(met[k], j_met[k]) <= 1e-5, k
    if ema:  # the statistics: same assignments, same sums
        j_counts, j_sums, j_res = (np.asarray(a) for a in j_aux[1])
        counts, sums, res = aux[1]
        np.testing.assert_array_equal(counts.numpy(), j_counts)
        np.testing.assert_allclose(sums.numpy(), j_sums, rtol=0,
                                   atol=1e-5 * np.abs(j_sums).max())
        np.testing.assert_allclose(res.numpy(), j_res, rtol=0, atol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, j_grads), tc)
    scale = 5e-2 if spec_weight > 0 and dtype == "float32" else 1e-4
    for name, p in tc.named_parameters():
        ref = want[name].numpy()
        if name == "codebooks" and ema:  # detached: the EMA rule trains it
            assert p.grad is None and not ref.any()
            continue
        got = p.grad.numpy()
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=scale * np.abs(ref).max() + 1e-7,
            err_msg=name)


@pytest.mark.parametrize("B,T", [(3, 800), (2, 1601)])
def test_stft_msstft_si_snr_match_jax(B, T):
    rng = np.random.default_rng(1)
    sig = (rng.standard_normal((B, T)) * 0.1).astype(np.float32)
    rec = (rng.standard_normal((B, T)) * 0.05).astype(np.float32)
    for n_fft, hop, win in ((256, 64, None), (512, 128, 400)):
        want = np.asarray(jax.jit(jdsp.stft_mag, static_argnums=(1, 2, 3))(
            jnp.asarray(sig), n_fft, hop, win))
        got = dsp.stft_mag(torch.from_numpy(sig), n_fft, hop, win).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    j_ms = float(jax.jit(jtrain.msstft_loss)(jnp.asarray(rec),
                                             jnp.asarray(sig)))
    assert _rel(train.msstft_loss(torch.from_numpy(rec),
                                  torch.from_numpy(sig)), j_ms) <= 1e-5
    np.testing.assert_allclose(
        dsp.si_snr(torch.from_numpy(rec), torch.from_numpy(sig)).numpy(),
        np.asarray(jdsp.si_snr(jnp.asarray(rec), jnp.asarray(sig))),
        rtol=1e-5, atol=1e-5)
    # the spectral loss's gradient, in float64 on both sides
    sig64, rec64 = sig.astype(np.float64), rec.astype(np.float64)
    with jax.enable_x64(True):
        j_val, j_g = jax.jit(jax.value_and_grad(jtrain.msstft_loss))(
            jnp.asarray(rec64), jnp.asarray(sig64))
        j_val, j_g = float(j_val), np.asarray(j_g)
    r = torch.from_numpy(rec64).requires_grad_()
    val = train.msstft_loss(r, torch.from_numpy(sig64))
    val.backward()
    assert _rel(val, j_val) <= 1e-12
    np.testing.assert_allclose(r.grad.numpy(), j_g, rtol=0,
                               atol=1e-9 * np.abs(j_g).max())


@pytest.mark.parametrize("steps,threshold", [(0, 1e9), (3, 1e9), (3, 2.0)])
def test_ema_update_with_restarts_matches_jax(jax_codec, monkeypatch, steps,
                                              threshold):
    """``expire_threshold`` above every count restarts every code from the
    batch's residuals at the JAX package's rows; 2.0 restarts some."""
    monkeypatch.setattr(train, "restart_rows", _jax_rows)
    rng = np.random.default_rng(2)
    C, H, N = 64, 16, 40
    counts = rng.integers(0, 4, (K, C)).astype(np.float32)
    sums = rng.standard_normal((K, C, H)).astype(np.float32)
    res = rng.standard_normal((K, N, H)).astype(np.float32)
    qs = {"cluster_size": np.abs(rng.standard_normal((K, C))).astype(
              np.float32) * 3,
          "embed_sum": rng.standard_normal((K, C, H)).astype(np.float32)}
    j_params, j_q = jtrain._ema_codebook_update(
        jax_codec.params, {**{k: jnp.asarray(v) for k, v in qs.items()},
                           "steps": jnp.asarray(steps, jnp.int32)},
        tuple(jnp.asarray(a) for a in (counts, sums, res)), K, 0.99,
        threshold)
    tc = _port(jax_codec)
    q = {**{k: torch.from_numpy(v) for k, v in qs.items()}, "steps": steps}
    train._ema_codebook_update(
        tc, q, tuple(torch.from_numpy(a) for a in (counts, sums, res)), K,
        0.99, threshold)
    assert q["steps"] == int(j_q["steps"]) == steps + 1
    for k in ("cluster_size", "embed_sum"):
        np.testing.assert_allclose(q[k].numpy(), np.asarray(j_q[k]), rtol=0,
                                   atol=1e-6 * max(1, np.abs(j_q[k]).max()))
    np.testing.assert_allclose(tc.codebooks.detach().numpy(),
                               np.asarray(j_params["codebooks"]), rtol=0,
                               atol=1e-6 * np.abs(j_params["codebooks"]).max())


def test_restart_rows_are_seeded_by_the_step():
    a, b = train.restart_rows(5, 2, 64, 40), train.restart_rows(5, 2, 64, 40)
    assert torch.equal(a, b) and a.shape == (2, 64) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 40
    assert not torch.equal(a, train.restart_rows(6, 2, 64, 40))


def test_rvq_gradients_match_jax():
    """The argmax carries no gradient; ``rvq_quantize``'s q reaches the
    codebooks through the lookup (and x nowhere), as in JAX; the EMA
    statistics are detached."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    cb = rng.standard_normal((3, 64, 16)).astype(np.float32)
    w = rng.standard_normal((2, 5, 16)).astype(np.float32)
    j_gx, j_gcb = jax.grad(
        lambda x, c: jnp.sum(j_rvq_quantize(x, c, 2)[1] * w),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(cb))
    xt = torch.from_numpy(x).requires_grad_()
    cbt = torch.from_numpy(cb).requires_grad_()
    toks, q = rvq_quantize(xt, cbt, 2)
    assert not toks.requires_grad
    gx, gcb = torch.autograd.grad((q * torch.from_numpy(w)).sum(),
                                  [xt, cbt], allow_unused=True)
    assert not np.asarray(j_gx).any() and (gx is None or not gx.any())
    np.testing.assert_allclose(gcb.numpy(), np.asarray(j_gcb), atol=1e-6)
    assert float(gcb[2].abs().max()) == 0.0  # stage 3 unused
    _, q2, counts, sums, res = rvq_quantize_stats(xt, cbt, 2)
    assert q2.requires_grad  # through the codebooks, as rvq_quantize
    assert not any(t.requires_grad for t in (counts, sums, res))


def test_to_jax_params_inverts_from_jax_params(jax_codec):
    tree = jax.tree.map(np.asarray, jax_codec.params)
    tc = _port(jax_codec)
    back = to_jax_params(from_jax_params(tree, tc), tc)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(KeyError):
        to_jax_params({"codebooks": tc.codebooks}, tc)


def test_port_checkpoint_loads_in_jax_with_identical_tokens(jax_codec,
                                                            tmp_path):
    """One train step in the port, saved as the JAX tree; the JAX package's
    ``load_params`` and ``Encodec`` give the port's tokens; the npz keys
    and sentinels round-trip through both packages' loaders."""
    tc = _port(jax_codec)
    optimizer = torch.optim.Adam(tc.parameters(), lr=1e-2)
    step = train.make_codec_train_step(tc, K)
    step(train.init_codec_opt_state(optimizer, tc, K), _batch(4))
    path = str(tmp_path / "ckpt.npz")
    save_params(path, to_jax_params(tc.state_dict(), tc))
    tree = j_load_params(path)
    jc = JEncodec(SR, SR, model_config=tiny_cfg(), num_codebooks=K,
                  params=tree)
    sig = _batch(5, B=2, T=1000)
    np.testing.assert_array_equal(np.asarray(jc.sig_to_toks(sig)),
                                  tc.sig_to_toks(sig).numpy())
    nested = {"a": [], "b": {}, "c": [np.ones(2), {"d": np.zeros(3)}]}
    save_params(str(tmp_path / "n.npz"), nested)
    for loaded in (load_params(str(tmp_path / "n.npz")),
                   j_load_params(str(tmp_path / "n.npz"))):
        assert loaded["a"] == [] and loaded["b"] == {}
        np.testing.assert_array_equal(loaded["c"][1]["d"], np.zeros(3))


def test_audio_utils_match_jax(tmp_path):
    np.testing.assert_array_equal(example_signal(16000, 0.25),
                                  jaudio.example_signal(16000, 0.25))
    sig = np.stack([example_signal(8000, 0.1), -example_signal(8000, 0.1)])
    path = str(tmp_path / "a.wav")
    write_wav(path, sig, 8000)
    got, sr = read_wav(path)
    want, j_sr = jaudio.read_wav(path)
    assert sr == j_sr == 8000 and got.shape == (2, 800)
    np.testing.assert_array_equal(got, np.asarray(want))
    # written ×32767 and rounded, read ÷32768 (the reference's numerics)
    np.testing.assert_allclose(got, sig, rtol=0, atol=2 / 32767)


def test_train_codec_entry_point_on_cpu(tmp_path, capsys):
    """Three steps with ``--device cpu`` on a 2-file WAV manifest (crops of
    0.5 s at 16 kHz), the validation report, and the JAX tree saved; the
    exit code says whether recon fell."""
    rows = []
    for i in range(2):
        path = tmp_path / f"utt{i}.wav"
        sig = example_signal(16000, 0.8 + 0.2 * i) * (0.5 + 0.3 * i)
        write_wav(str(path), sig, 16000)
        rows.append({"ID": f"utt{i}", "duration": len(sig) / 16000,
                     "wav": str(path)})
    manifest = tmp_path / "train.csv"
    with open(manifest, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["ID", "duration", "wav"])
        w.writeheader()
        w.writerows(rows)
    out = tmp_path / "ckpt.npz"
    rc = train_codec.main([
        "--device", "cpu", "--steps", "3", "--batch", "2", "--log-every",
        "1", "--train-manifest", str(manifest), "--valid-manifest",
        str(manifest), "--spec-weight", "1.0", "--spec-ramp", "2",
        "--cosine-decay", "--out", str(out)])
    text = capsys.readouterr().out
    assert sum(line.startswith("step ") for line in text.splitlines()) == 3
    first, final = map(float, text.split("; recon ")[1].splitlines()[0].split()[::2])
    assert rc == (0 if final < first else 1)
    assert "valid SI-SNR" in text
    tree = j_load_params(str(out))
    assert sorted(tree) == ["codebooks", "decoder", "encoder"]
    assert tree["codebooks"].shape == (4, 256, 32)
