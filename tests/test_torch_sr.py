"""Port parity for the speech-resynthesis evaluation (``audiocodecs_tpu_torch/
downstream/``, ``examples/sweep_sr.py``) against the JAX package, on the CPU.

* Configs: every YAML under ``hparams/`` and the legacy cases of
  ``tests/test_legacy_hparams.py`` load to dicts equal to the JAX
  package's.
* The synthetic corpus: the same manifests and sha256-equal WAV files.
* ``BucketedLoader``: the same ids, arrays and lengths batch for batch.
* STOI and PESQ: bit-equal; MelD and STFTD within 1e-5 relative; DNSMOS
  within 1e-4 on two 3 s signals; ``CodebookUtilization`` and
  ``MetricStats``: exact.
* ``run_sr`` on the small EnCodec of ``tests/test_recipes.py`` (weights from
  one ``checkpoint:`` npz for both) over a 6-utterance corpus, with the
  control rows off, and on with an ``in_wav`` row: the same summary
  keys; per utterance SI-SNR within 1e-3 dB, MelD and STFTD within 1e-4
  relative, STOI within 1e-4, PESQ within 1e-3, DNSMOS within 1e-4;
  ``codebook_util`` exact.
"""

import glob
import hashlib
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from audiocodecs_tpu.downstream import config as jconfig
from audiocodecs_tpu.downstream.datasets import loader as jloader
from audiocodecs_tpu.downstream.datasets import manifest as jmanifest
from audiocodecs_tpu.downstream.datasets import synthetic as jsynthetic
from audiocodecs_tpu.downstream.metrics import base as jbase
from audiocodecs_tpu.downstream.metrics import codebook_util as jcbu
from audiocodecs_tpu.downstream.metrics import dnsmos as jdnsmos
from audiocodecs_tpu.downstream.metrics import dsp as jdsp
from audiocodecs_tpu.downstream.metrics import pesq as jpesq
from audiocodecs_tpu.downstream.metrics import stoi as jstoi
from audiocodecs_tpu.downstream.recipes import sr as jsr
from audiocodecs_tpu_torch.downstream import config
from audiocodecs_tpu_torch.downstream.datasets import loader, manifest
from audiocodecs_tpu_torch.downstream.datasets import synthetic
from audiocodecs_tpu_torch.downstream.metrics import base, codebook_util
from audiocodecs_tpu_torch.downstream.metrics import dnsmos, dsp, pesq, stoi
from audiocodecs_tpu_torch.downstream.recipes import quality, sr
from audiocodecs_tpu_torch.examples import sweep_sr
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.params import to_jax_params
from audiocodecs_tpu_torch.utils.audio import read_wav, write_wav
from audiocodecs_tpu_torch.utils.checkpoint import save_params
from test_legacy_hparams import FIXTURE, SMOKE
from zoo_pairs import one_thread  # noqa: F401 (autouse)

HP = os.path.join(os.path.dirname(__file__), "..", "hparams")
YAMLS = sorted(glob.glob(os.path.join(HP, "*", "*.yaml")))

# tests/test_recipes.py's TINY_CODEC
TINY_CODEC = {
    "name": "encodec",
    "orig_sample_rate": 16000,
    "num_codebooks": 2,
    "model_overrides": {
        "sampling_rate": 16000, "num_filters": 4, "hidden_size": 16,
        "upsampling_ratios": [20, 16], "codebook_size": 32,
        "codebook_dim": 16, "num_quantizers": 4,
    },
}


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("path", YAMLS, ids=[
    os.path.relpath(p, HP) for p in YAMLS])
def test_load_config_matches_jax(path):
    assert config.load_config(path) == jconfig.load_config(path)


@pytest.mark.parametrize("text", [FIXTURE, SMOKE], ids=["fixture", "smoke"])
def test_legacy_configs_match_jax(tmp_path, text):
    p = tmp_path / "legacy.yaml"
    p.write_text(text)
    assert config.load_config(str(p)) == jconfig.load_config(str(p))
    argv = [str(p), "--data_folder", "/data", "--seed", "3"]
    assert config.parse_cli(argv) == jconfig.parse_cli(argv)


def test_merge_overrides_and_dump():
    a, b = {"x": 1, "n": {"k": 2}}, {"y": "s"}
    assert config.merge_configs([a, b]) == jconfig.merge_configs([a, b])
    with pytest.raises(ValueError, match="duplicate config key"):
        config.merge_configs([a, a], ["a.yaml", "b.yaml"])
    over = {"n.k": 5, "n.m": [1, 2], "z": None}
    assert (config.apply_overrides(a, over)
            == jconfig.apply_overrides(a, over))
    for s in ("false", "None", "3e-4", "[1, 2]", "text"):
        assert config._parse_value(s) == jconfig._parse_value(s)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same corpus from both packages: (port manifests, JAX ones)."""
    d = tmp_path_factory.mktemp("corpus")
    kw = dict(sample_rate=16000, num_utts=6, min_seconds=0.3,
              max_seconds=0.8)
    return (synthetic.prepare_synthetic(str(d / "port"), **kw),
            jsynthetic.prepare_synthetic(str(d / "jax"), **kw))


def test_synthetic_corpus_is_byte_identical(corpus):
    port, jax_ = corpus
    assert sorted(port) == sorted(jax_) == ["test", "train", "valid"]
    for split in port:
        rows = manifest.read_manifest(port[split])
        jrows = jmanifest.read_manifest(jax_[split])
        assert len(rows) == len(jrows)
        for r, jr in zip(rows, jrows):
            for k in r:
                if k.endswith("wav"):
                    assert os.path.basename(r[k]) == os.path.basename(jr[k])
                    assert _sha(r[k]) == _sha(jr[k]), r[k]
                else:
                    assert r[k] == jr[k], k
    fingerprints = [os.path.join(os.path.dirname(m["test"]),
                                 "_fingerprint.json") for m in corpus]
    assert _sha(fingerprints[0]) == _sha(fingerprints[1])


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, num_buckets=2),
    dict(batch_size=4, num_buckets=3, batch_seconds=1.0, shuffle=True,
         seed=3, sorting="descending", num_workers=2, prefetch=1),
    dict(batch_size=3, num_buckets=2, sorting="random", drop_last=True,
         num_workers=3),
], ids=["plain", "dynamic", "random"])
def test_bucketed_loader_matches_jax(corpus, kw):
    rows = manifest.read_manifest(corpus[0]["train"])
    got = loader.BucketedLoader(rows, 16000, **kw)
    want = jloader.BucketedLoader(rows, 16000, **kw)
    assert got.buckets == want.buckets and len(got) == len(want)
    for _ in range(2):  # two epochs: the shuffle's seed moves on
        batches, jbatches = list(got), list(want)
        assert len(batches) == len(jbatches) > 0
        for b, jb in zip(batches, jbatches):
            assert b["ids"] == jb["ids"]
            np.testing.assert_array_equal(b["sig"], jb["sig"])
            np.testing.assert_array_equal(b["length"], jb["length"])


def _speech(seed, seconds=1.0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * seed
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t + seed)
    return (0.2 * sig * env + 0.01 * rng.standard_normal(t.size)).astype(
        np.float32)


@pytest.mark.parametrize("sr_", [16000, 24000])
def test_stoi_and_pesq_bit_equal(sr_):
    ref = _speech(0, 0.7, sr_)
    hyp = ref + 0.05 * np.random.default_rng(1).standard_normal(
        ref.size).astype(np.float32)
    assert stoi.stoi(hyp, ref, sr_) == jstoi.stoi(hyp, ref, sr_)
    assert pesq.pesq(hyp, ref, sr_) == jpesq.pesq(hyp, ref, sr_)
    assert (pesq.pesq(hyp, ref, sr_, "nb")
            == jpesq.pesq(hyp, ref, sr_, "nb"))


def test_mel_and_stft_distance_match_jax():
    hyp = np.stack([_speech(2), _speech(3)])
    ref = np.stack([_speech(4), _speech(5)])[:, :15000]
    th, tr = torch.from_numpy(hyp), torch.from_numpy(ref)
    for got, want in (
            (dsp.mel_distance(th, tr, 16000),
             jdsp.mel_distance(jnp.asarray(hyp), jnp.asarray(ref), 16000)),
            (dsp.mel_distance(th, tr, 24000, 512, 128, 64),
             jdsp.mel_distance(jnp.asarray(hyp), jnp.asarray(ref), 24000,
                               512, 128, 64)),
            (dsp.stft_distance(th, tr),
             jdsp.stft_distance(jnp.asarray(hyp), jnp.asarray(ref))),
            (dsp.stft_distance(th, tr, 512, 128),
             jdsp.stft_distance(jnp.asarray(hyp), jnp.asarray(ref), 512,
                                128))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for htk in (True, False):
        np.testing.assert_array_equal(
            dsp.mel_filterbank(22050, 1024, 80, 20.0, None, htk),
            jdsp.mel_filterbank(22050, 1024, 80, 20.0, None, htk))


def test_dnsmos_matches_jax():
    """Two 3 s signals (tiled to 12 s: three 9.01 s windows each), and one
    at 24 kHz through the resampler."""
    for seed, rate in ((6, 16000), (7, 16000), (8, 24000)):
        sig = _speech(seed, 3.0, rate)
        got = dnsmos.dnsmos_p808(sig, rate, device="cpu")
        want = jdnsmos.dnsmos_p808(sig, rate)
        assert abs(got - want) <= 1e-4, (seed, got, want)
    assert np.isnan(dnsmos.dnsmos_p808(np.zeros(0), 16000, device="cpu"))


def test_dnsmos_state_dict_maps_every_array():
    sd = dnsmos.dnsmos_state_dict()
    assert sorted(sd) == sorted(dnsmos.DNSMOS().state_dict())
    with np.load(dnsmos.DEFAULT_PARAMS_PATH) as raw:
        np.testing.assert_array_equal(sd["dense.0.weight"].numpy(),
                                      raw["dense0_w"].T)


def test_codebook_utilization_and_metric_stats_exact(tmp_path):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 12, (3, 20, 2))
    lens = np.array([1.0, 0.5, 0.25], np.float32)
    for vs in (None, [12, 7]):
        got = codebook_util.CodebookUtilization(2, 12, vs)
        want = jcbu.CodebookUtilization(2, 12, vs)
        for g in (got, want):
            g.append(toks % (7 if vs else 12), lens)
            g.append(toks[:1])
        assert got.summarize() == want.summarize()

    def metric(a, b):
        return np.abs(np.asarray(a) - np.asarray(b)).sum(-1)

    got, want = base.MetricStats(metric, "L1"), jbase.MetricStats(metric,
                                                                  "L1")
    x = rng.standard_normal((2, 4))
    for s in (got, want):
        s.append(["a", "b"], x, np.zeros((2, 4)))
        s.append(["c"], [np.nan], [0.0])
    assert got.summarize() == want.summarize()
    got.write_stats(str(tmp_path / "p.txt"))
    want.write_stats(str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    with pytest.raises(ValueError, match="scores for"):
        got.append(["x"], np.zeros((2, 4)), np.zeros((2, 4)))


@pytest.fixture(scope="module")
def sr_inputs(tmp_path_factory, corpus):
    """One checkpoint for both packages (the port's seeded init in the
    reference's tree), the test manifest, and a manifest with an
    ``in_wav`` column: a noisy copy for the first row, the row's own WAV
    for the others."""
    d = tmp_path_factory.mktemp("sr_inputs")
    mc = EncodecModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in
                               TINY_CODEC["model_overrides"].items()})
    tc = Encodec(16000, 16000, num_codebooks=2, model_config=mc, device="cpu")
    ckpt = str(d / "tiny.npz")
    save_params(ckpt, to_jax_params(tc.state_dict(), tc))
    test_csv = corpus[1]["test"]
    rows = manifest.read_manifest(test_csv)
    sig, rate = read_wav(rows[0]["wav"])
    noisy = sig[0] + 0.05 * np.random.default_rng(0).standard_normal(
        sig.shape[-1]).astype(np.float32)
    write_wav(str(d / "noisy0.wav"), noisy, rate)
    for i, r in enumerate(rows):
        r["in_wav"] = str(d / "noisy0.wav") if i == 0 else r["wav"]
    noisy_csv = str(d / "noisy_test.csv")
    manifest.write_manifest(noisy_csv, rows)
    return ckpt, test_csv, noisy_csv


def _stats(out_dir):
    """Per-utterance values of every metric file run_sr wrote."""
    out = {}
    for path in glob.glob(os.path.join(out_dir, "*.txt")):
        lines = open(path).read().splitlines()
        out[os.path.basename(path)] = {
            u: float(v) for u, v in (l.split("\t") for l in lines[1:-1])}
    return out


_LIMITS = {"sisnr": (1e-3, 0), "meld": (0, 1e-4), "stftd": (0, 1e-4),
           "stoi": (1e-4, 0), "pesq": (1e-3, 0), "dnsmos": (1e-4, 0)}


@pytest.fixture(scope="module")
def jax_codec(sr_inputs):
    """The JAX codec of the checkpoint, built once for the three cases
    (its jitted encode and decode compile once a shape)."""
    return jconfig.build_codec(
        {"codec": {**TINY_CODEC, "checkpoint": sr_inputs[0]}}, 16000)


@pytest.mark.parametrize("case", ["plain", "control_rows_in_wav"])
def test_run_sr_matches_jax(tmp_path, monkeypatch, sr_inputs, jax_codec,
                            case):
    """The JAX side reuses one codec of the same checkpoint, and its RTF
    timers (chained loops, four XLA compiles a batch shape) are replaced by
    a constant: no metric reads them."""
    monkeypatch.setattr(jconfig, "build_codec", lambda cfg, sr: jax_codec)
    monkeypatch.setattr(jsr, "_make_shape_timers", lambda codec, reps: (
        lambda sig: 1.0, lambda toks: 1.0))
    ckpt, test_csv, noisy_csv = sr_inputs
    cfg = {"sample_rate": 16000,
           "codec": {**TINY_CODEC, "checkpoint": ckpt},
           "test_csv": noisy_csv if case != "plain" else test_csv,
           "test_batch_size": 2, "num_length_buckets": 2,
           "compute_ref_metrics": case != "plain",
           "save_audios": case != "plain"}
    got = sr.run_sr({**cfg, "output_folder": str(tmp_path / "port")},
                    device="cpu")
    want = jsr.run_sr({**cfg, "output_folder": str(tmp_path / "jax")})
    assert sorted(got) == sorted(want)
    assert got["codebook_util"] == want["codebook_util"]
    assert got["norm_entropy"] == want["norm_entropy"]
    assert got["num_batches"] == want["num_batches"]
    assert got["RealTime"] == want["RealTime"]
    assert got["RTF"] > 0 and got["iRTF"] > 0
    stats, jstats = _stats(str(tmp_path / "port")), _stats(
        str(tmp_path / "jax"))
    assert sorted(stats) == sorted(jstats)
    for name, vals in stats.items():
        assert sorted(vals) == sorted(jstats[name]), name
        metric = name[:-4]
        for prefix in ("rec", "ref", "orig"):
            if metric.startswith(prefix) and metric[len(prefix):] in _LIMITS:
                metric = metric[len(prefix):]
        atol, rtol = _LIMITS[metric]
        for uid, v in vals.items():
            w = jstats[name][uid]  # the files keep 6 decimals
            assert abs(v - w) <= atol + rtol * abs(w) + 1e-6, (name, uid, v, w)
    if case != "plain":
        # the noisy row's Orig control scores its noisy input
        uid = manifest.read_manifest(noisy_csv)[0]["ID"]
        assert stats["origsisnr.txt"][uid] < 40.0
        for tag in ("hyp", "rec", "ref", "in"):
            port_wav = tmp_path / "port" / "audios" / f"{uid}_{tag}.wav"
            jax_wav = tmp_path / "jax" / "audios" / f"{uid}_{tag}.wav"
            assert port_wav.is_file(), tag
            if tag in ("ref", "in"):
                assert _sha(port_wav) == _sha(jax_wav), tag


def test_unported_gates_and_profiler_raise(sr_inputs, tmp_path):
    """Every model-backed gate now builds its metric, so a gate whose file
    is missing raises (as the reference's ``_require`` does) instead of
    dropping the metric; ``use_profiler`` no longer raises but writes
    ``profiler.txt`` and the summary's ``"profiler"`` key."""
    for key in ("utmos_checkpoint", "whisper_path",
                "speaker_encoder_model_path", "speaker_encoder_checkpoint",
                "whisper_checkpoint"):
        with pytest.raises((RuntimeError, OSError, ValueError)):
            quality.build_quality_metrics(
                {key: str(tmp_path / "missing")}, 16000,
                ("utmos", "dnsmos", "dwer", "spk"), device="cpu")
    with pytest.raises(RuntimeError, match="unavailable"):
        quality.build_quality_metrics(
            {"lm_path": str(tmp_path / "missing"),
             "whisper_path": str(tmp_path / "missing")}, 16000,
            device="cpu")
    ckpt, test_csv, _ = sr_inputs
    summary = sr.run_sr({"sample_rate": 16000, "test_csv": test_csv,
                         "codec": dict(TINY_CODEC), "checkpoint": ckpt,
                         "use_profiler": True, "profiler_seconds": [0.25],
                         "compute_metrics": False,
                         "output_folder": str(tmp_path / "out")},
                        device="cpu")
    assert sorted(summary["profiler"]) == ["params_m"]
    report = (tmp_path / "out" / "profiler.txt").read_text()
    assert "GMACs" in report and "0.25s" in report


def test_pair_battery_matches_the_recipe_metrics():
    ref = _speech(9, 1.0)
    hyp = ref + 0.02 * np.random.default_rng(2).standard_normal(
        ref.size).astype(np.float32)
    bat = quality.PairBattery({}, 16000, device="cpu")
    bat.score_pair(hyp, ref, uid="u0")
    bat.score_single(ref, prefix="Ref", uid="u0")
    s = bat.summary()
    assert sorted(s) == ["DNSMOS", "MelD", "PESQ", "RefDNSMOS", "STFTD",
                         "STOI"]
    assert s["STOI"] == jstoi.stoi(hyp, ref, 16000)
    assert s["PESQ"] == jpesq.pesq(hyp, ref, 16000)
    assert abs(s["MelD"] - float(jdsp.mel_distance(
        jnp.asarray(hyp)[None], jnp.asarray(ref)[None], 16000)[0])) <= (
        1e-5 * s["MelD"])


def test_sweep_sr_example_on_cpu(tmp_path, capsys):
    """EnCodec-24k at its published width over a 5-utterance synthetic
    corpus (one test utterance), the shipped task YAML without the control
    rows."""
    yamls = {}
    for axis, name, update in (
            ("datasets", "synthetic", dict(prep_dir=str(tmp_path / "corpus"),
                                           num_utterances=5)),
            ("tasks", "sr", dict(compute_ref_metrics=False))):
        with open(os.path.join(HP, axis, f"{name}.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg.update(update)
        yamls[axis] = tmp_path / f"{name}.yaml"
        yamls[axis].write_text(yaml.safe_dump(cfg))
    assert sweep_sr.main([
        "--codecs", "encodec", "--dataset", str(yamls["datasets"]),
        "--task", str(yamls["tasks"]), "--output_folder",
        str(tmp_path / "out"), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== encodec =="
    assert lines[-3].split() == ["codec", "iRTF", "SISNR", "MelD", "STOI",
                                 "CBUtil"]
    cells = lines[-1].split()
    assert cells[0] == "encodec" and len(cells) == 6
    assert all(np.isfinite(float(c)) for c in cells[1:])
    assert os.path.isfile(tmp_path / "out" / "encodec" / "summary.json")
