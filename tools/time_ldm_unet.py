"""Time SemantiCodec's LDM UNet and VAE decoder on the card in their conv
forms, and show how two bf16 runs part.

At the published widths (seeded init, as ``chip_smoke.py``'s) and the
shapes of one decode of 8 windows (the UNet's CFG batch B' = 16 on the
256 x 16 latent, the VAE on 8 latents), it prints one JSON line:

* ``unet_ms``: one exact fp32 UNet call as the port runs it (each conv an
  unfold and one cuBLAS product, ``nn/ldm_unet.py::_conv``) and with every
  conv on cuDNN instead, their max difference; the bf16 call;
* ``vae_ms``: the VAE decoder on cuDNN, as the port runs it, and with its
  convs as unfold products instead;
* ``bf16_ops``: each bf16 conv and product of the UNet call against the
  same op in float64 on its bf16 operands, as a ratio of rms errors to
  the rounding's own (1.0: rounded right);
* ``bf16_batch``: rows 0-1 of the UNet call run alone (B' = 2) against
  the same rows inside B' = 16, in bf16 and in fp32, beside the bf16
  call's move off fp32.

    python3 tools/time_ldm_unet.py  # the card, about 30 s
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from audiocodecs_tpu_torch.nn import ldm_unet, ldm_vae  # noqa: E402
from audiocodecs_tpu_torch.nn.layers import exact_fp32  # noqa: E402


def _rms(t) -> float:
    return float(t.double().pow(2).mean().sqrt())


def _ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bf16_ops(unet, x, t, ctx, cfg):
    """Each bf16 conv and product of one UNet call against float64."""
    calls, mm, conv = [], torch.matmul, F.conv2d

    def rec_mm(a, b, **kw):
        out = mm(a, b, **kw)
        if out.dtype == torch.bfloat16:
            calls.append((mm, a, b, {}, out))
        return out

    def rec_conv(a, w, b=None, stride=1, padding=0, **kw):
        out = conv(a, w, b, stride, padding, **kw)
        if out.dtype == torch.bfloat16:
            calls.append((lambda p, q, **k: conv(p, q, None, **k), a, w,
                          {"stride": stride, "padding": padding}, out))
        return out

    torch.matmul, F.conv2d = rec_mm, rec_conv
    try:
        ldm_unet.apply_unet(unet, x, t, ctx, cfg, torch.bfloat16)
    finally:
        torch.matmul, F.conv2d = mm, conv
    ratios = []
    for fn, a, b, kw, out in calls:
        exact = fn(a.double(), b.double(), **kw)
        rounding = _rms(exact.to(torch.bfloat16).double() - exact)
        ratios.append(_rms(out.double() - exact) / rounding)
    return {"ops": len(ratios), "max_ratio": max(ratios),
            "min_ratio": min(ratios)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this tool times the card")
    g = torch.Generator().manual_seed(0)
    cfg = ldm_unet.UNetConfig(context_dim=1536)
    unet = ldm_unet.UNet(cfg)
    unet.load_state_dict(ldm_unet.init_unet_params(g, cfg))
    vae = ldm_vae.AutoencoderKL(ldm_vae.AUDIOLDM_VAE)
    vae.load_state_dict(ldm_vae.init_vae_params(g, ldm_vae.AUDIOLDM_VAE))
    unet.cuda()
    vae.cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((16, 8, 256, 16), device="cuda", generator=gen)
    ctx = torch.randn((16, 512, 1536), device="cuda", generator=gen)
    t = torch.full((16,), 981.0, device="cuda")
    out = {"card": torch.cuda.get_device_name(0)}
    with torch.inference_mode(), exact_fp32():
        def run(dt=torch.float32, rows=slice(None)):
            return ldm_unet.apply_unet(unet, x[rows], t[rows], ctx[rows],
                                       cfg, dt)

        y = run()
        unfold_ms = _ms(run)
        bf16_ms = _ms(lambda: run(torch.bfloat16))
        ldm_unet._conv, saved = (lambda h, c, **kw: ldm_vae.conv2d(
            h, c, **kw)), ldm_unet._conv
        try:
            y_cudnn = run()
            cudnn_ms = _ms(run)
        finally:
            ldm_unet._conv = saved
        out["unet_ms"] = {"unfold_cublas": unfold_ms, "cudnn": cudnn_ms,
                          "bf16": bf16_ms,
                          "max_diff": float((y - y_cudnn).abs().max()),
                          "max_abs": float(y.abs().max())}

        def decode():
            return ldm_vae.apply_vae_decoder(vae, x[:8], ldm_vae.AUDIOLDM_VAE)

        vae_ms = _ms(decode)
        # the UNet's fp32 conv (an unfold and one product) in the VAE
        ldm_vae.conv2d, saved = ldm_unet._conv, ldm_vae.conv2d
        try:
            vae_unfold_ms = _ms(decode)
        finally:
            ldm_vae.conv2d = saved
        out["vae_ms"] = {"cudnn": vae_ms, "unfold_cublas": vae_unfold_ms}
        out["bf16_ops"] = _bf16_ops(unet, x, t, ctx, cfg)
        yb = run(torch.bfloat16)
        two = slice(0, 2)
        out["bf16_batch"] = {
            "move_rms": _rms(yb.float() - y),
            "bf16_rows_alone_rms": _rms(run(torch.bfloat16, two).float()
                                        - yb[two].float()),
            "fp32_rows_alone_rms": _rms(run(rows=two) - y[two])}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
