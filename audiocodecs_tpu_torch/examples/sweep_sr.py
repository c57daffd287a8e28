"""Batched resynthesis sweep across codecs via the port's SR evaluation.

Counterpart of ``examples/sweep_sr.py`` (BASELINE config #5), with the same
arguments, default codecs and table, plus ``--device`` (the card by
default): the SR evaluation (:mod:`..downstream.recipes.sr`) of several
codec families on one dataset, then a comparison table (iRTF, SI-SNR,
MelD, STOI, codebook utilization).

    python -m audiocodecs_tpu_torch.examples.sweep_sr \\
        --codecs encodec dac mimi speechtokenizer
    python -m audiocodecs_tpu_torch.examples.sweep_sr \\
        --dataset hparams/datasets/librispeech.yaml \\
        --data_folder /data/LibriSpeech
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--codecs", nargs="+",
                   default=["encodec", "dac", "mimi", "speechtokenizer"])
    p.add_argument("--dataset", default="hparams/datasets/synthetic.yaml")
    p.add_argument("--task", default="hparams/tasks/sr.yaml")
    p.add_argument("--data_folder", default=None)
    p.add_argument("--output_folder", default="/tmp/sr_sweep")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from audiocodecs_tpu_torch.downstream.config import (
        load_config,
        merge_configs,
    )
    from audiocodecs_tpu_torch.downstream.recipes.common import prepare_data
    from audiocodecs_tpu_torch.downstream.recipes.sr import run_sr

    rows = []
    for name in args.codecs:
        cfg = merge_configs(
            [load_config(args.task), load_config(args.dataset)],
            [args.task, args.dataset],
        )
        cfg["codec"] = {"name": name}
        cfg["test_batch_size"] = args.batch_size
        cfg["output_folder"] = f"{args.output_folder}/{name}"
        if args.data_folder:
            cfg["data_folder"] = args.data_folder
        cfg = prepare_data(cfg)
        print(f"== {name} ==", flush=True)
        s = run_sr(cfg, device=args.device)
        rows.append((name, s))

    hdr = (f"{'codec':>16} {'iRTF':>9} {'SISNR':>8} {'MelD':>8} {'STOI':>7} "
           f"{'CBUtil':>7}")
    print("\n" + hdr)
    print("-" * len(hdr))
    for name, s in rows:
        print(f"{name:>16} {s['iRTF']:>9.1f} {s['SISNR']:>8.2f} "
              f"{s['MelD']:>8.2f} {s['STOI']:>7.3f} "
              f"{s['codebook_util']:>7.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
