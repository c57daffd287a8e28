"""The port's profiler and the SR evaluation's timing
(``audiocodecs_tpu_torch/downstream/profiler.py``, ``downstream/recipes/
sr.py``), on the CPU.

* ``profile_fn``: the reference's fields; a matmul's FLOPs exactly
  (2·64·128·128, the counter's count); the kernels' tallies added to the
  counter's (each kernel formula equal to what
  ``torch.utils.flop_counter.FlopCounterMode`` counts for its plain
  version, in every form).
* ``profile_codec`` and ``format_report`` on a tiny EnCodec: the keys, and
  the report line for line as the JAX package's ``format_report`` writes
  the same numbers.
* ``_chained_seconds`` cancels a fixed cost under a patched clock; the
  shape timers call each chain length as ``rtf_reps`` says, once a shape;
  ``run_sr`` reads ``rtf_reps`` and, with ``use_profiler``, writes
  ``profiler.txt`` and the summary's ``"profiler"`` key with the JAX
  ``run_sr``'s keys.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from audiocodecs_tpu.downstream import profiler as jprofiler
from audiocodecs_tpu.downstream.datasets import synthetic as jsynthetic
from audiocodecs_tpu.downstream.recipes import sr as jsr
from audiocodecs_tpu_torch.downstream import profiler
from audiocodecs_tpu_torch.downstream.recipes import sr
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.ops.dac_resunit import (
    dac_resunit,
    dac_resunit_flops,
)
from audiocodecs_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence,
    lstm_recurrence_flops,
)
from audiocodecs_tpu_torch.ops.seanet_resblock import (
    seanet_resblock,
    seanet_resblock_flops,
    seanet_resblock_packed,
)
from audiocodecs_tpu_torch.params import to_jax_params
from audiocodecs_tpu_torch.utils.checkpoint import save_params
from zoo_pairs import one_thread  # noqa: F401 (autouse)

FIELDS = ("time_s", "time_min_s", "time_pipelined_s", "gflops", "gmacs",
          "bytes_accessed_gb", "memory")


def test_profile_fn_fields_and_matmul_flops():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 128)).astype(np.float32))
    x = torch.ones(64, 128)
    r = profiler.profile_fn(lambda a, b: torch.tanh(a @ b.T), (x, w),
                            runs=4, warmups=1)
    assert sorted(r) == sorted(FIELDS)
    assert r["gflops"] == 2 * 64 * 128 * 128 / 1e9
    assert r["gmacs"] == r["gflops"] / 2
    assert r["time_s"] > 0 and r["time_min_s"] <= r["time_s"]
    assert r["time_pipelined_s"] > 0
    # the matmul reads x and w and writes 64x128; tanh reads and writes it
    assert r["bytes_accessed_gb"] * 1e9 >= 4 * (64 * 128 * 2 + 128 * 128)
    assert r["memory"]["argument_bytes"] == 4 * (64 * 128 + 128 * 128)
    assert r["memory"]["output_bytes"] == 4 * 64 * 128
    assert r["memory"]["peak_bytes_in_use"] is None


def _case(name):
    g = torch.Generator().manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=g)

    if name == "lstm":
        T, B, H = 5, 3, 32
        args = (randn(T, B, 4 * H), randn(H, 4 * H), randn(B, H),
                randn(B, H))
        return (lambda: lstm_recurrence(*args),
                lstm_recurrence_flops(T, B, H))
    if name.startswith("resblock"):
        prec = name.split("_")[1]
        B, C, Hc, T = 2, 8, 4, 17
        args = (randn(B, C, T), randn(B, C, 2), randn(Hc, C, 3), randn(Hc),
                randn(C, Hc, 1), randn(C), randn(C, C, 1), randn(C))
        return (lambda: seanet_resblock(*args, precision=prec),
                seanet_resblock_flops(B, C, Hc, T, prec))
    if name == "packed":
        B, T, C, Hc = 2, 19, 8, 4
        args = (randn(B, T, C), randn(3, C, Hc), randn(Hc), randn(Hc, C),
                randn(C), randn(C, C), randn(C))
        return (lambda: seanet_resblock_packed(*args),
                seanet_resblock_flops(B, C, Hc, T))
    prec = name.split("_")[1]
    B, C, T = 2, 8, 23
    args = (randn(B, C, T), randn(C, C, 7), randn(C), randn(C).abs() + 0.5,
            randn(C, C, 1), randn(C), randn(C).abs() + 0.5)
    return (lambda: dac_resunit(*args, 3, precision=prec),
            dac_resunit_flops(B, C, T))


@pytest.mark.parametrize("name", ["lstm", "resblock_exact",
                                  "resblock_default", "packed", "unit_exact",
                                  "unit_default"])
def test_kernel_flop_formula_is_the_counters_plain_version(name):
    call, formula = _case(name)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        call()
    assert counter.get_total_flops() == formula


def test_kernel_tallies_join_the_count(monkeypatch):
    """What a wrapper tallies during the counted call (as a kernel launch
    on the card does) is added to the counter's FLOPs and bytes."""
    monkeypatch.setattr(lstm_recurrence, "flops", 0)
    monkeypatch.setattr(lstm_recurrence, "bytes", 0)

    def fn(x):
        lstm_recurrence.flops += 10 ** 6
        lstm_recurrence.bytes += 4096
        return x * 2

    r = profiler.profile_fn(fn, (torch.ones(8),), runs=2, warmups=1)
    assert r["gflops"] == 1e-3  # the counted call's tally alone
    # x * 2 reads and writes 8 floats, the tally adds 4096
    assert r["bytes_accessed_gb"] == (64 + 4096) / 1e9


_TINY = EncodecModelConfig(sampling_rate=800, num_filters=4, hidden_size=16,
                           upsampling_ratios=(4, 2), codebook_size=32,
                           codebook_dim=16, num_quantizers=2)


def test_profile_codec_sweep_and_report():
    codec = Encodec(800, 800, num_codebooks=2, model_config=_TINY,
                    device="cpu", generator=torch.Generator().manual_seed(0))
    res = profiler.profile_codec(codec, seconds=(1, 0.5), runs=2, warmups=1)
    assert sorted(res) == ["0.5s", "1s", "params_m"]
    for key in ("1s", "0.5s"):
        assert sorted(res[key]) == sorted(FIELDS + ("rtf",))
        assert res[key]["rtf"] > 0 and res[key]["gflops"] > 0
    assert res["1s"]["gflops"] > res["0.5s"]["gflops"]
    assert res["params_m"] == sum(
        t.numel() for t in codec.state_dict().values()) / 1e6
    assert profiler.format_report(res) == jprofiler.format_report(res)


def test_chained_seconds_cancels_a_fixed_cost(monkeypatch):
    clock = [0.0]
    lengths = []

    def run(R):
        lengths.append(R)
        clock[0] += 5.0 + 2.0 * R  # a fixed cost and 2 s a call

    monkeypatch.setattr(sr.time, "perf_counter", lambda: clock[0])
    got = sr._chained_seconds(run, 1, 4, torch.device("cpu"))
    assert got == pytest.approx(2.0)
    # warm both lengths, then each twice, as the reference
    assert lengths == [1, 4, 1, 4, 1, 4]
    with pytest.raises(ZeroDivisionError):
        sr._chained_seconds(run, 3, 3, torch.device("cpu"))


def test_shape_timers_follow_rtf_reps():
    calls = {"enc": 0, "dec": 0}

    class _Codec:
        device = torch.device("cpu")

        def sig_to_toks(self, sig):
            calls["enc"] += 1

        def toks_to_sig(self, toks):
            calls["dec"] += 1

    enc, dec = sr._make_shape_timers(_Codec(), (2, 5))
    for _ in range(2):  # memoised: the second call times nothing
        enc(torch.zeros(1, 10))
        dec(torch.zeros(1, 3, 2))
    assert calls == {"enc": 3 * (2 + 5), "dec": 3 * (2 + 5)}
    enc(torch.zeros(2, 10))  # a new shape
    assert calls["enc"] == 6 * (2 + 5)


@pytest.fixture(scope="module")
def tiny_sr(tmp_path_factory):
    d = tmp_path_factory.mktemp("sr")
    csv = jsynthetic.prepare_synthetic(str(d / "corpus"), sample_rate=16000,
                                       num_utts=4, min_seconds=0.3,
                                       max_seconds=0.5)["test"]
    mc = EncodecModelConfig(sampling_rate=16000, num_filters=4,
                            hidden_size=16, upsampling_ratios=(20, 16),
                            codebook_size=32, codebook_dim=16,
                            num_quantizers=4)
    codec = Encodec(16000, 16000, num_codebooks=2, model_config=mc,
                    device="cpu")
    ckpt = str(d / "tiny.npz")
    save_params(ckpt, to_jax_params(codec.state_dict(), codec))
    cfg = {"sample_rate": 16000, "test_csv": csv, "checkpoint": ckpt,
           "codec": {"name": "encodec", "orig_sample_rate": 16000,
                     "num_codebooks": 2, "model_overrides": {
                         "sampling_rate": 16000, "num_filters": 4,
                         "hidden_size": 16, "upsampling_ratios": [20, 16],
                         "codebook_size": 32, "codebook_dim": 16,
                         "num_quantizers": 4}},
           "compute_metrics": False, "use_profiler": True,
           "profiler_seconds": [0.25, 0.5]}
    return d, cfg


def test_run_sr_reads_rtf_reps_and_writes_the_profile(tiny_sr, monkeypatch):
    d, cfg = tiny_sr
    seen = []
    make = sr._make_shape_timers

    def spy(codec, reps=(1, 4)):
        seen.append(tuple(reps))
        return make(codec, reps)

    monkeypatch.setattr(sr, "_make_shape_timers", spy)
    out = d / "port"
    summary = sr.run_sr({**cfg, "rtf_reps": [2, 3],
                         "output_folder": str(out)}, device="cpu")
    assert seen == [(2, 3)]
    jsummary = jsr.run_sr({**cfg, "output_folder": str(d / "jax")})
    assert sorted(summary) == sorted(jsummary)
    assert sorted(summary["profiler"]) == sorted(jsummary["profiler"])
    assert summary["profiler"]["params_m"] == pytest.approx(
        jsummary["profiler"]["params_m"])
    report = (out / "profiler.txt").read_text().splitlines()
    jreport = (d / "jax" / "profiler.txt").read_text().splitlines()
    assert [ln.split()[0] for ln in report] == [
        ln.split()[0] for ln in jreport]
    assert summary["iRTF"] > 0 and np.isfinite(summary["RTF"])
    assert os.path.isfile(out / "summary.json")
