"""Speech resynthesis evaluation (SR) — the metric-bearing entry point.

Counterpart of ``audiocodecs_tpu/downstream/recipes/sr.py`` (reference
``test_sr.py:54-167,241-335,379-391``): every manifest row is encoded and
decoded by the codec on its device, then scored by the battery SI-SNR,
MelD, STFTD, STOI, PESQ and DNSMOS (plus CodebookUtil), and by the gated
model-backed metrics of :mod:`.quality` (UTMOS, dWER and dCER, SpkSim),
with the Rec/Ref/Orig control rows under ``compute_ref_metrics``. A row
with an ``in_wav`` column is evaluated noisy-in, clean-out (reference
``test_sr.py:44-51``); otherwise both are the row's ``wav``.

Batches come from the bucketed loader, so a codec sees a few shapes. RTF
and iRTF come from timing the full public path (``sig_to_toks`` and
``toks_to_sig``, resampling included) once for each bucket shape by the
reference's slope between two chain lengths (``rtf_reps``, default
``(1, 4)``): ``R`` calls back to back, timed on the card between two
``torch.cuda.Event`` records after a synchronise and on the CPU by
``perf_counter``, the least of two runs of each length, and the
difference over ``reps_hi - reps_lo`` calls, so the fixed cost of a timed
window cancels. The times are summed over the batches as the reference
sums its slopes. Metrics and host copies are never inside a timed window.
``use_profiler`` adds :func:`..profiler.profile_codec`'s sweep
(``profiler_seconds``, default 1, 2 and 4 s at B = 1): ``profiler.txt``
and the summary's ``"profiler"`` key.

Run:
    python -m audiocodecs_tpu_torch.downstream.recipes.sr \\
        hparams/tasks/sr.yaml hparams/codecs/encodec.yaml \\
        hparams/datasets/synthetic.yaml --output_folder /tmp/sr \\
        [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from audiocodecs_tpu_torch.downstream.recipes.quality import (
    reconcile_length as _reconcile,
    trim_row as _trim,
)

__all__ = ["run_sr", "main"]


def _span_seconds(run, reps: int, device: torch.device) -> float:
    """Seconds of ``run(reps)``: on the card between two
    ``torch.cuda.Event`` records after a synchronise, closed by a
    synchronise on the second; on the CPU by ``perf_counter``."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        run(reps)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    run(reps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _chained_seconds(run, reps_lo: int, reps_hi: int,
                     device: torch.device) -> float:
    """Seconds a call by the slope between two chain lengths: ``run(R)``
    makes R calls back to back; each length is run once warm and twice
    timed, and the least of the two taken, so fixed cost (the sync, the
    first launch's latency) cancels in the difference."""
    run(reps_lo)  # warm both lengths
    run(reps_hi)
    t_lo = t_hi = float("inf")
    for _ in range(2):
        t_lo = min(t_lo, _span_seconds(run, reps_lo, device))
        t_hi = min(t_hi, _span_seconds(run, reps_hi, device))
    return max(t_hi - t_lo, 1e-9) / (reps_hi - reps_lo)


def _make_shape_timers(codec, reps=(1, 4)):
    """Encode and decode timers memoised by input shape; each times the
    full public path (``sig_to_toks``, ``toks_to_sig``, resampling
    included) by :func:`_chained_seconds` over ``reps``."""
    cache: dict = {}

    def chain(fn):
        def run(R):
            for _ in range(R):
                fn()
        return run

    def encode_seconds(sig) -> float:
        key = ("enc", tuple(sig.shape))
        if key not in cache:
            cache[key] = _chained_seconds(
                chain(lambda: codec.sig_to_toks(sig)), *reps, codec.device)
        return cache[key]

    def decode_seconds(toks) -> float:
        key = ("dec", tuple(toks.shape))
        if key not in cache:
            cache[key] = _chained_seconds(
                chain(lambda: codec.toks_to_sig(toks)), *reps, codec.device)
        return cache[key]

    return encode_seconds, decode_seconds


def run_sr(cfg: dict, device=None) -> dict:
    """Run the SR evaluation of ``cfg`` (task, codec and dataset axes
    merged) with the codec and the device metrics on ``device`` (the card
    when ``None``); writes ``summary.json``, the per-metric stats files and,
    with ``save_audios``, the hyp/rec/ref/in WAVs under ``output_folder``,
    and returns the summary."""
    from audiocodecs_tpu_torch.downstream.config import (
        build_codec,
        dump_config,
    )
    from audiocodecs_tpu_torch.downstream.datasets.loader import (
        BucketedLoader,
    )
    from audiocodecs_tpu_torch.downstream.datasets.manifest import (
        filter_by_duration,
        read_manifest,
    )
    from audiocodecs_tpu_torch.downstream.metrics.base import MetricStats
    from audiocodecs_tpu_torch.downstream.metrics.codebook_util import (
        CodebookUtilization,
    )
    from audiocodecs_tpu_torch.downstream.metrics.dsp import (
        mel_distance,
        si_snr,
        stft_distance,
    )
    from audiocodecs_tpu_torch.downstream.metrics.pesq import pesq
    from audiocodecs_tpu_torch.downstream.metrics.stoi import stoi
    from audiocodecs_tpu_torch.downstream.recipes.common import loader_kwargs
    from audiocodecs_tpu_torch.downstream.recipes.quality import (
        build_quality_metrics,
    )
    from audiocodecs_tpu_torch.utils.audio import read_wav, write_wav

    for required in ("sample_rate", "test_csv", "codec"):
        if required not in cfg:
            raise ValueError(
                f"config is missing {required!r} — did you pass all three "
                "axes (task.yaml codec.yaml dataset.yaml)?"
            )
    sample_rate = int(cfg["sample_rate"])
    out_dir = cfg.get("output_folder", "results/sr")
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, out_dir)

    rows = read_manifest(cfg["test_csv"], cfg.get("data_folder"))
    rows = filter_by_duration(
        rows, cfg.get("test_remove_if_shorter", 0.0),
        cfg.get("test_remove_if_longer", float("inf")),
    )
    lkw = loader_kwargs(cfg)
    lkw["batch_size"] = int(cfg.get("test_batch_size", 4))
    lkw["num_buckets"] = int(cfg.get("num_length_buckets", 4))
    loader = BucketedLoader(rows, sample_rate, **lkw)
    codec = build_codec(cfg, sample_rate, device=device)
    dev = codec.device
    compute_metrics = bool(cfg.get("compute_metrics", True))
    compute_ref = bool(cfg.get("compute_ref_metrics", False))

    # ---- pairwise metric battery (hyp vs clean reference) ---- #
    def _per_utt(fn):
        """Batch metric from a per-utterance fn over length-trimmed rows."""
        def metric(hyps, refs, lens):
            return [fn(_trim(np.asarray(h), l), _trim(np.asarray(r), l))
                    for h, r, l in zip(hyps, refs, lens)]
        return metric

    def _dsp(fn):
        return _per_utt(lambda h, r: float(fn(
            torch.as_tensor(h, device=dev)[None],
            torch.as_tensor(r, device=dev)[None])[0]))

    pairwise = {
        "SISNR": _dsp(si_snr),
        "MelD": _dsp(lambda h, r: mel_distance(h, r, sample_rate)),
        "STFTD": _dsp(stft_distance),
        "STOI": _per_utt(lambda h, r: stoi(h, r, sample_rate)),
        "PESQ": _per_utt(lambda h, r: pesq(h, r, sample_rate)),
    }
    quality = build_quality_metrics(cfg, sample_rate,
                                    want=("utmos", "dnsmos", "dwer", "spk"),
                                    device=dev)
    single = quality["single"]  # single-signal metrics: fn(sig_row) -> float
    if quality["dwer"] is not None:
        dwer = quality["dwer"]
        pairwise["dWER"] = _per_utt(
            lambda h, r: float(dwer.metric([h], [r], sample_rate)[0]))
        if hasattr(dwer, "cer"):  # reference dWER also reports CER
            pairwise["dCER"] = _per_utt(
                lambda h, r: float(dwer.cer([h], [r], sample_rate)[0]))
    if quality["spk"] is not None:
        spk = quality["spk"]
        pairwise["SpkSim"] = _per_utt(
            lambda h, r: float(spk.metric(h[None], r[None], sample_rate)[0]))

    # hyp rows + Rec/Ref/Orig control rows (reference test_sr.py:115-143)
    stats: dict[str, MetricStats] = {}
    for name, fn in pairwise.items():
        stats[name] = MetricStats(fn, name)
        if compute_ref:
            stats[f"Rec{name}"] = MetricStats(fn, f"Rec{name}")
            stats[f"Orig{name}"] = MetricStats(fn, f"Orig{name}")
    for name, fn in single.items():
        qfn = lambda sigs, lens, _f=fn: [  # noqa: E731
            _f(_trim(np.asarray(s), l)) for s, l in zip(sigs, lens)]
        stats[name] = MetricStats(qfn, name)
        if compute_ref:
            for variant in ("Rec", "Ref", "Orig"):
                stats[f"{variant}{name}"] = MetricStats(qfn,
                                                        f"{variant}{name}")
    cbu = CodebookUtilization(codec.config.num_codebooks,
                              codec.config.vocab_size,
                              vocab_sizes=codec.config.vocab_sizes)

    encode_time = decode_time = real_time = 0.0
    timer_reps = tuple(cfg.get("rtf_reps", (1, 4)))
    enc_seconds, dec_seconds = _make_shape_timers(codec, timer_reps)
    dump_audio = bool(cfg.get("save_audios", False))
    audio_dir = os.path.join(out_dir, "audios")
    if dump_audio:
        os.makedirs(audio_dir, exist_ok=True)

    def _read_in_sig(batch):
        """Noisy input column, padded to the clean batch's static shape."""
        if not any("in_wav" in r for r in batch["rows"]):
            return None
        T = batch["sig"].shape[1]
        out = np.zeros_like(batch["sig"])
        for i, r in enumerate(batch["rows"]):
            sig, sr = read_wav(r.get("in_wav", r["wav"]))
            if sr != sample_rate:
                raise ValueError(f"{r['ID']}: in_wav rate {sr} != "
                                 f"{sample_rate}")
            n = min(sig.shape[-1], T)
            out[i, :n] = sig[0, :n]
        return out

    n_batches = 0
    for batch in loader:
        out_np = np.asarray(batch["sig"])
        in_np = _read_in_sig(batch)
        distinct_in = in_np is not None
        if in_np is None:
            in_np = out_np
        lens = np.asarray(batch["length"])
        out_sig = torch.from_numpy(out_np).to(dev)
        in_sig = torch.from_numpy(in_np).to(dev) if distinct_in else out_sig
        length = torch.from_numpy(lens).to(dev)

        hyp_toks = codec.sig_to_toks(in_sig, length)
        out_toks = (codec.sig_to_toks(out_sig, length) if distinct_in
                    else hyp_toks)
        hyp_sig = codec.toks_to_sig(hyp_toks, length)
        rec_sig = (codec.toks_to_sig(out_toks, length) if distinct_in
                   else hyp_sig)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        # timed once per shape (the chain-length slope), then accumulated
        encode_time += enc_seconds(in_sig) * (2 if distinct_in else 1)
        decode_time += dec_seconds(hyp_toks) * (2 if distinct_in else 1)
        real_time += float(np.sum(lens) * out_np.shape[1]) / sample_rate

        hyp_np = _reconcile(hyp_sig.cpu().numpy(), out_np.shape[1])
        rec_np = (_reconcile(rec_sig.cpu().numpy(), out_np.shape[1])
                  if distinct_in else hyp_np)

        ids = batch["ids"]
        if compute_metrics:
            for name in pairwise:
                stats[name].append(ids, hyp_np, out_np, lens)
                if compute_ref:
                    stats[f"Rec{name}"].append(ids, rec_np, out_np, lens)
                    stats[f"Orig{name}"].append(ids, in_np, out_np, lens)
            for name in single:
                stats[name].append(ids, hyp_np, lens)
                if compute_ref:
                    stats[f"Rec{name}"].append(ids, rec_np, lens)
                    stats[f"Ref{name}"].append(ids, out_np, lens)
                    stats[f"Orig{name}"].append(ids, in_np, lens)
            cbu.append(out_toks.cpu().numpy(), lens)

        if dump_audio:  # hyp/rec/ref/in like the reference (test_sr.py:144)
            for i, uid in enumerate(ids):
                n = max(int(float(lens[i]) * out_np.shape[1]), 1)
                for tag, arr in (("hyp", hyp_np), ("rec", rec_np),
                                 ("ref", out_np), ("in", in_np)):
                    write_wav(os.path.join(audio_dir, f"{uid}_{tag}.wav"),
                              arr[i, :n], sample_rate)
        n_batches += 1

    summary = {name: m.summarize("average") for name, m in stats.items()}
    summary.update(
        {
            "RealTime": real_time,
            "ProcessTimeEncode": encode_time,
            "ProcessTimeDecode": decode_time,
            "RTF": (encode_time + decode_time) / max(real_time, 1e-9),
            "iRTF": real_time / max(encode_time + decode_time, 1e-9),
            "num_batches": n_batches,
            "codebook_util": cbu.summarize("avg_utilization"),
            "norm_entropy": cbu.summarize("avg_norm_entropy"),
        }
    )

    if cfg.get("use_profiler", False):
        from audiocodecs_tpu_torch.downstream.profiler import (
            format_report,
            profile_codec,
        )

        prof = profile_codec(
            codec, seconds=cfg.get("profiler_seconds", (1, 2, 4)), batch=1,
        )
        summary["profiler"] = {
            k: v for k, v in prof.items() if not isinstance(v, dict)
        }
        with open(os.path.join(out_dir, "profiler.txt"), "w") as f:
            f.write(format_report(prof))

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    for name, m in stats.items():
        m.write_stats(os.path.join(out_dir, f"{name.lower()}.txt"))
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.recipes.common import run_cli

    return run_cli(run_sr, argv)


if __name__ == "__main__":
    sys.exit(main())
