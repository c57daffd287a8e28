"""Port parity for the utilities around the codecs (``audiocodecs_tpu_torch/
utils/``, ``native/wavio.py``, the reconstruct and stream examples) against
the JAX package, on the CPU.

* ``windowed_reconstruct`` on the small EnCodec of ``tests/test_recipes.py``
  over 2.5 windows (three, crossfaded) on the same weights as the JAX
  ``utils/windowed.py``: within 1e-4 · max|sig|.
* ``masking``: exact.
* WAV I/O at sample widths 1-4: the native reader equals the ``wave``
  reader and the JAX package's native reader bit for bit; written files are
  byte-equal across the two writers and the JAX package's.
* Train state: three steps with a save and a resume after the second equal
  three uninterrupted steps bit for bit.
"""

import re
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.models.encodec import EncodecModelConfig as JConfig
from audiocodecs_tpu.native import wavio as jwavio
from audiocodecs_tpu.utils import audio as jaudio
from audiocodecs_tpu.utils import masking as jmasking
from audiocodecs_tpu.utils.windowed import (
    windowed_reconstruct as j_windowed_reconstruct,
)
from audiocodecs_tpu_torch.examples import reconstruct, stream
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.native import wavio
from audiocodecs_tpu_torch.parallel import train
from audiocodecs_tpu_torch.params import to_jax_params
from audiocodecs_tpu_torch.utils import masking
from audiocodecs_tpu_torch.utils.audio import read_wav, write_wav
from audiocodecs_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
)
from audiocodecs_tpu_torch.utils.windowed import (
    window_starts,
    windowed_reconstruct,
)
from zoo_pairs import one_thread  # noqa: F401 (autouse)

# tests/test_recipes.py's TINY_CODEC
TINY = dict(sampling_rate=16000, num_filters=4, hidden_size=16,
            upsampling_ratios=(20, 16), codebook_size=32, codebook_dim=16,
            num_quantizers=4)


@pytest.fixture(scope="module")
def tiny_pair():
    """The port's seeded init, carried to the JAX codec (JAX's eager init
    of even this model takes seconds)."""
    tc = Encodec(16000, 16000, num_codebooks=2, device="cpu",
                 model_config=EncodecModelConfig(**TINY))
    jc = JEncodec(16000, 16000, num_codebooks=2, model_config=JConfig(**TINY),
                  params=to_jax_params(tc.state_dict(), tc))
    return jc, tc


@pytest.mark.parametrize("T", [16000, 6400])
def test_windowed_reconstruct_matches_jax(tiny_pair, T):
    """0.4 s windows, 10 % overlap: 1 s is three windows (the last
    zero-padded), 0.4 s one roundtrip (the window's shape, which the JAX
    codec has compiled once already)."""
    jc, tc = tiny_pair
    sig = (np.random.default_rng(T).standard_normal((2, T)) * 0.3).astype(
        np.float32)
    got = windowed_reconstruct(tc, sig, window_seconds=0.4)
    want = np.asarray(j_windowed_reconstruct(jc, sig, window_seconds=0.4))
    assert got.shape == want.shape == (2, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    if T == 16000:
        assert window_starts(T, 6400, 5760) == [0, 5760, 11520]


def test_masking_matches_jax():
    length = np.array([0.0, 0.25, 0.5, 0.375, 1.0, 0.0625], np.float32)
    for total in (8, 16, 7):
        np.testing.assert_array_equal(
            masking.relative_to_absolute(torch.from_numpy(length), total),
            np.asarray(jmasking.relative_to_absolute(jnp.asarray(length),
                                                     total)))
        for dtype, jdtype in ((torch.bool, jnp.bool_),
                              (torch.float32, jnp.float32)):
            np.testing.assert_array_equal(
                masking.length_mask(torch.from_numpy(length), total, dtype),
                np.asarray(jmasking.length_mask(jnp.asarray(length), total,
                                                jdtype)))
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    for axis in (-1, 0, 1):
        for fn, jfn, arg in ((masking.pad_to_multiple,
                              jmasking.pad_to_multiple, 4),
                             (masking.pad_to_bucket, jmasking.pad_to_bucket,
                              (3, 5, 9))):
            got, n = fn(torch.from_numpy(x), arg, axis, value=-1.0)
            want, jn = jfn(jnp.asarray(x), arg, axis, value=-1.0)
            assert n == jn
            np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="no bucket"):
        masking.pad_to_bucket(torch.from_numpy(x), (1, 2))


def _pcm_file(path, width, channels=2, frames=501, rate=22050, seed=0):
    raw = np.random.default_rng(seed).integers(
        0, 256, frames * channels * width, dtype=np.uint8)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(raw.tobytes())


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_native_reader_matches_wave_and_jax_bit_for_bit(tmp_path, width):
    path = str(tmp_path / f"w{width}.wav")
    _pcm_file(path, width, seed=width)
    got, sr = read_wav(path)
    plain, sr_plain = read_wav(path, native=False)
    want, sr_jax = jwavio.read_wav_native(path)
    assert sr == sr_plain == sr_jax == 22050
    assert got.shape == plain.shape == want.shape == (2, 501)
    assert got.dtype == plain.dtype == np.float32
    for other in (plain, np.asarray(want)):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      other.view(np.uint32))


def test_writers_are_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    sig = rng.standard_normal((2, 777)).astype(np.float32) * 0.7
    # clipped values, exact grid points and negative fractions (truncation)
    sig[0, :6] = [1.5, -1.5, 1.0, -1.0, -0.5 / 32767, 0.5 / 32767]
    files = {}
    for name, write in (("native", lambda p: write_wav(p, sig, 16000)),
                        ("wave", lambda p: write_wav(p, sig, 16000,
                                                     native=False)),
                        ("jax", lambda p: jaudio.write_wav(p, sig, 16000))):
        path = str(tmp_path / f"{name}.wav")
        write(path)
        files[name] = open(path, "rb").read()
    assert files["native"] == files["wave"] == files["jax"]
    mono = str(tmp_path / "mono.wav")
    write_wav(mono, sig[0], 16000)
    back, sr = read_wav(mono)
    assert sr == 16000 and back.shape == (1, 777)
    np.testing.assert_array_equal(back, read_wav(str(tmp_path / "wave.wav"),
                                                 native=False)[0][:1])
    # float32 files: the native writer's 32-bit form reads back exactly
    f32 = str(tmp_path / "f32.wav")
    wavio.write_wav_native(f32, sig, 16000, bits=32)
    np.testing.assert_array_equal(read_wav(f32)[0], sig)


def test_native_library_builds_into_the_package(tmp_path):
    path = wavio.library_path()
    wavio.load()
    assert path.is_file() and path.parent.name == "_build"
    with pytest.raises(ValueError, match="not a RIFF"):
        bad = tmp_path / "bad.wav"
        bad.write_bytes(b"nothing")
        read_wav(str(bad))


SR = 800
K = 2


def _tiny_model(seed):
    return Encodec(SR, SR, num_codebooks=K, device="cpu",
                   generator=torch.Generator().manual_seed(seed),
                   model_config=EncodecModelConfig(
                       sampling_rate=SR, num_filters=8, hidden_size=16,
                       upsampling_ratios=(4, 2), codebook_size=64,
                       codebook_dim=16, num_quantizers=2))


def _run(model, ema):
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.5, 0.9))
    state = (train.init_codec_opt_state(optimizer, model, K) if ema
             else optimizer)
    kw = (dict(spec_weight=1.0, spec_delay=0, spec_ramp=2, commit_warmup=2)
          if ema else dict(ema_decay=None, spec_weight=0.5))
    return state, train.make_codec_train_step(model, K, **kw)


def _batch(i):
    return (np.random.default_rng(10 + i).standard_normal((3, SR))
            * 0.1).astype(np.float32)


@pytest.mark.parametrize("ema", [True, False])
def test_resumed_train_state_continues_bit_for_bit(tmp_path, ema):
    whole = _tiny_model(0)
    state, step = _run(whole, ema)
    for i in range(3):
        last = step(state, _batch(i))

    first = _tiny_model(0)
    state1, step1 = _run(first, ema)
    for i in range(2):
        step1(state1, _batch(i))
    path = str(tmp_path / "state.pt")
    save_train_state(path, first, state1)
    resumed = _tiny_model(7)  # other weights: the file must replace them
    state2, step2 = _run(resumed, ema)
    load_train_state(path, resumed, state2)
    got = step2(state2, _batch(2))

    for k, v in whole.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k
    for k in last:
        assert torch.equal(got[k], last[k]), k
    if ema:
        assert state2[1]["steps"] == state[1]["steps"] == 3
        for k in ("cluster_size", "embed_sum"):
            assert torch.equal(state2[1][k], state[1][k])
    opt, opt2 = (state[0], state2[0]) if ema else (state, state2)
    for p, p2 in zip(whole.parameters(), resumed.parameters()):
        for k, v in opt.state[p].items():
            assert torch.equal(opt2.state[p2][k], v), k
    with pytest.raises(ValueError, match="EMA"):
        load_train_state(path, _tiny_model(0), _run(_tiny_model(0),
                                                    not ema)[0])


def test_reconstruct_example_on_cpu(tmp_path, capsys):
    out = tmp_path / "rec.wav"
    assert reconstruct.main(["--device", "cpu", "--out", str(out),
                             "--num-codebooks", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(
        r"encodec: \(1, 24000\) @ 24000 Hz -> tokens \(1, 75, 2\) -> "
        r"\(1, 24000\) \([0-9.]+s incl\. compile, [0-9.]+x realtime\)",
        lines[0]), lines[0]
    assert lines[1] == f"wrote {out}"
    rec, sr = read_wav(str(out))
    assert sr == 24000 and rec.shape == (1, 24000)
    assert np.isfinite(rec).all() and np.abs(rec).max() > 0


def test_stream_example_on_cpu(capsys):
    """Mimi at its published width, four one-frame chunks: the streamed
    tokens equal the batch encode's, so the exit code is 0."""
    assert stream.main(["--device", "cpu", "--seconds", "0.32",
                        "--frames-per-chunk", "1", "--num-codebooks",
                        "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"streamed 4 chunks of 80 ms \(1 frames\) in "
                        r"[0-9.]+s incl\. compile", lines[0]), lines[0]
    assert lines[1:] == ["tokens vs batch encode: 100.0% match",
                         "decoded 0.32s of audio"]


def test_server_rejection_names_windowed_reconstruct():
    from audiocodecs_tpu_torch.examples.serve import CodecServer

    server = CodecServer.__new__(CodecServer)
    server.buckets = [100]
    with pytest.raises(ValueError, match="use windowed_reconstruct for "
                                         "long audio"):
        server.submit(np.zeros(101, np.float32))
