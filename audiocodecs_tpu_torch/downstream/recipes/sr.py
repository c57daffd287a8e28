"""Speech resynthesis evaluation (SR) — the metric-bearing entry point.

Counterpart of ``audiocodecs_tpu/downstream/recipes/sr.py`` (reference
``test_sr.py:54-167,241-335,379-391``): every manifest row is encoded and
decoded by the codec on its device, then scored by the battery SI-SNR,
MelD, STFTD, STOI, PESQ and DNSMOS (plus CodebookUtil), with the
Rec/Ref/Orig control rows under ``compute_ref_metrics``. A row with an
``in_wav`` column is evaluated noisy-in, clean-out (reference
``test_sr.py:44-51``); otherwise both are the row's ``wav``.

Batches come from the bucketed loader, so a codec sees a few shapes. RTF
and iRTF come from timing the full public path (``sig_to_toks`` and
``toks_to_sig``, resampling included) once for each bucket shape, after a
warm call: on the card between two ``torch.cuda.Event`` records closed by a
synchronise, with no host copy inside; on the CPU by ``perf_counter``. The
times are summed over the batches as the reference sums its chained-loop
slopes. Metrics and host copies are never inside a timed window.

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


def _seconds(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn`` after a warm call."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _make_shape_timers(codec):
    """Encode and decode timers memoised by input shape."""
    cache: dict = {}

    def encode_seconds(sig) -> float:
        key = ("enc", tuple(sig.shape))
        if key not in cache:
            cache[key] = _seconds(lambda: codec.sig_to_toks(sig),
                                  codec.device)
        return cache[key]

    def decode_seconds(toks) -> float:
        key = ("dec", tuple(toks.shape))
        if key not in cache:
            cache[key] = _seconds(lambda: codec.toks_to_sig(toks),
                                  codec.device)
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
    if cfg.get("use_profiler", False):
        raise NotImplementedError(
            "use_profiler: downstream/profiler.py is not ported to "
            "audiocodecs_tpu_torch yet (ROADMAP.md A.10)")
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
    enc_seconds, dec_seconds = _make_shape_timers(codec)
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

        # timed once per shape, then accumulated
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

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    for name, m in stats.items():
        m.write_stats(os.path.join(out_dir, f"{name.lower()}.txt"))
    return summary


def main(argv=None):
    """``task.yaml codec.yaml dataset.yaml [--key value ...]``; ``--device
    cpu`` runs on the CPU (the card otherwise)."""
    from audiocodecs_tpu_torch.downstream.config import parse_cli
    from audiocodecs_tpu_torch.downstream.recipes.common import prepare_data

    cfg, _ = parse_cli(argv if argv is not None else sys.argv[1:])
    device = cfg.pop("device", None)
    cfg = prepare_data(cfg)
    summary = run_sr(cfg, device=device)
    print(json.dumps(summary, indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
