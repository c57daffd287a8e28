"""How far two correct CPU decodes of a serving tier part, with the conv
implementation switched (oneDNN on, then off: other summation orders).

For DAC-44.1k (fast and throughput tiers) and BigCodec-16k (balanced) on
seeded random weights and 1 s of noise, prints:

* end to end: rms(decode − decode') against the tier's own move off exact
  fp32, rms(decode − exact);
* teacher forced: each decoder residual unit fed the input it got in the
  first decode, its output with oneDNN off against the first decode's, as a
  share of the unit's own move (the tier's unit against the exact unit on
  the same input), and the control (the exact unit in the tier's place).

``chip_smoke.py`` holds the card against the CPU in the same two ways.

    python3 tools/tier_divergence.py  # the CPU only, about 5 minutes
"""

from __future__ import annotations

import numpy as np
import torch

from audiocodecs_tpu_torch.models.bigcodec import BigCodec
from audiocodecs_tpu_torch.models.dac import DAC, residual_unit_io
from audiocodecs_tpu_torch.serving import apply_serving_preset


def _rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def _cases():
    g = torch.Generator().manual_seed(0)
    exact = DAC(44100, 44100, num_codebooks=9, device="cpu", generator=g)
    state = exact.state_dict()
    yield "dac_44k", 44100, exact, {
        name: DAC(44100, 44100, num_codebooks=9, device="cpu",
                  state_dict=state, **apply_serving_preset("dac", q, b))
        for name, q, b in (("fast", "fast", 1), ("throughput", "balanced",
                                                 8))}
    g = torch.Generator().manual_seed(0)
    exact = BigCodec(16000, 16000, latent=False, device="cpu", generator=g)
    state = exact.state_dict()
    yield "bigcodec_16k", 16000, exact, {
        "balanced": BigCodec(16000, 16000, latent=False, device="cpu",
                             state_dict=state,
                             **apply_serving_preset("bigcodec"))}


def main() -> None:
    torch.set_num_threads(4)
    for family, sr, exact, tiers in _cases():
        sig = (np.random.default_rng(13).standard_normal((1, sr)) * 0.1
               ).astype(np.float32)
        toks = exact.sig_to_toks(sig)
        y_exact = exact.toks_to_sig(toks)
        e_units = dict(exact.decoder.named_modules())
        for tier_name, tier in tiers.items():
            with residual_unit_io(tier.decoder) as (ins, outs):
                y = tier.toks_to_sig(toks)
            with torch.backends.mkldnn.flags(enabled=False):
                y2 = tier.toks_to_sig(toks)
            move, part = _rms(y - y_exact), _rms(y - y2)
            top = float((y - y2).abs().max())
            print(f"{family} {tier_name}: end to end rms(decode - decode') "
                  f"{part:.3e} = {part / move:.3f} of the tier's move "
                  f"{move:.3e}; max {top:.3e} = "
                  f"{top / float(y_exact.abs().max()):.3e} of max|sig|",
                  flush=True)
            t_units = dict(tier.decoder.named_modules())
            worst, control = 0.0, float("inf")
            with torch.inference_mode():
                for name, x in ins.items():
                    with torch.backends.mkldnn.flags(enabled=False):
                        other = t_units[name](x).float()
                    ex = e_units[name](x.float())
                    unit_move = _rms(other - ex)
                    worst = max(worst, _rms(other - outs[name].float())
                                / unit_move)
                    control = min(control, _rms(ex - outs[name].float())
                                  / unit_move)
            print(f"{family} {tier_name}: {len(ins)} units teacher forced: "
                  f"rms(unit - unit') at most {worst:.4f} of the unit's "
                  f"move; control (exact in the tier's place) at least "
                  f"{control:.4f}", flush=True)


if __name__ == "__main__":
    main()
