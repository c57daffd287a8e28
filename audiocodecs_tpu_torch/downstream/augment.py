"""Train-time waveform augmentation: DropFreq and DropChunk.

Counterpart of ``audiocodecs_tpu/downstream/augment.py``. The reference
recipes augment the input signal before tokenization when ``augment: True``
(reference ``train_asr.py:46-48``): DropFreq then DropChunk through a
SpeechBrain Augmenter, both applied when the ``augment_prob`` coin lands
(reference ``hparams/tasks/asr.yaml:40-41,62-93``). The reference yaml's
``drop_length_low/high = 1/5`` and ``drop_count_low/high = 1000/2000``
mean 1000-2000 micro-drops of 1-5 samples, and the defaults here are those.

Each augmentation is split in two: a **draw** (:func:`draw_drop_freq`,
:func:`draw_drop_chunk`, :meth:`Augmenter.draw`) that makes every random
number from a ``torch.Generator``, and an **apply** that takes the draws.
The draws have the reference's shapes and ranges (``count_high`` candidate
notches or chunks, an active mask from the drawn count), so the reference
package's draws fed to the apply give its output.

The notches of one row are composed into one FIR kernel of
``count_high · 100 + 1`` taps and applied as one depthwise conv. The
augmented waveform is tokenized, so every product runs with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = ["Augmenter", "apply_drop_chunk", "apply_drop_freq",
           "build_augmenter", "draw_drop_chunk", "draw_drop_freq",
           "drop_chunk", "drop_freq"]

_NOTCH_LEN = 101  # FIR length (odd, linear phase)


def _notch_kernels(freq: torch.Tensor, width: float) -> torch.Tensor:
    """Windowed-sinc band-stops at relative ``freq`` [...] (1 = Nyquist) →
    [..., 101]: a low-pass at ``freq - width`` plus a spectrally inverted
    low-pass at ``freq + width`` (SpeechBrain's ``notch_filter``)."""
    pad = _NOTCH_LEN // 2
    n = torch.arange(_NOTCH_LEN, device=freq.device) - pad
    nf = n.to(torch.float32)
    win = torch.blackman_window(_NOTCH_LEN, periodic=False,
                                device=freq.device)

    def lp(cut):
        cut = cut[..., None]
        h = torch.where(n == 0, 2.0 * cut,
                        torch.sin(torch.pi * cut * nf)
                        / (torch.pi * nf + 1e-20))
        h = h * win
        return h / torch.sum(h, dim=-1, keepdim=True)

    lo = torch.clamp(freq - width, 1e-3, 1.0)
    hi = torch.clamp(freq + width, 1e-3, 1.0)
    hhpf = -lp(hi)
    hhpf[..., pad] += 1.0  # spectral inversion → high-pass
    return lp(lo) + hhpf


def draw_drop_freq(batch: int, generator: torch.Generator, *,
                   freq_low: float = 0.0, freq_high: float = 1.0,
                   count_low: int = 1, count_high: int = 3) -> dict:
    """DropFreq's draws for ``batch`` rows, on the generator's device:
    ``freqs`` [B, count_high] uniform in [max(freq_low, 0.01),
    min(freq_high, 0.99)) and ``counts`` [B] in [count_low, count_high]."""
    dev = generator.device
    lo, hi = max(freq_low, 1e-2), min(freq_high, 1.0 - 1e-2)
    freqs = lo + (hi - lo) * torch.rand(batch, count_high,
                                        generator=generator, device=dev)
    counts = torch.randint(count_low, count_high + 1, (batch,),
                           generator=generator, device=dev)
    return {"freqs": freqs, "counts": counts}


def apply_drop_freq(sig: torch.Tensor, draws: dict, *,
                    width: float = 0.05) -> torch.Tensor:
    """Notch ``sig`` [B, T] at each row's first ``counts`` of ``freqs``.

    The notches are composed at full length, ``n · 100 + 1`` taps for n
    candidates, so none is truncated (SpeechBrain applies them one after
    another, which equals the composition), then applied in one depthwise
    conv with zero padding, the output as long as the input."""
    B, _ = sig.shape
    freqs = draws["freqs"].to(device=sig.device, dtype=torch.float32)
    counts = draws["counts"].to(sig.device)
    n_cand = freqs.shape[1]
    active = (torch.arange(n_cand, device=sig.device)[None, :]
              < counts[:, None])
    delta_l = torch.zeros(_NOTCH_LEN, device=sig.device)
    delta_l[_NOTCH_LEN // 2] = 1.0
    notches = torch.where(active[..., None], _notch_kernels(freqs, width),
                          delta_l)  # [B, n, 101]
    full_len = n_cand * (_NOTCH_LEN - 1) + 1
    kern = torch.zeros(B, full_len, device=sig.device)
    kern[:, full_len // 2] = 1.0
    pad = _NOTCH_LEN // 2
    with exact_fp32():
        for i in range(n_cand):
            # a 'same' convolution of each row's carry with its notch: the
            # carry's support stays centred and within full_len, so the
            # trim loses nothing (the notches are symmetric; flipped all
            # the same, as a convolution flips them)
            kern = F.conv1d(F.pad(kern[None], (pad, pad)),
                            torch.flip(notches[:, i], (-1,))[:, None],
                            groups=B)[0]
        half = full_len // 2
        y = F.conv1d(F.pad(sig[None], (half, half)), kern[:, None],
                     groups=B)
    return y[0]


def drop_freq(sig: torch.Tensor, generator: torch.Generator, *,
              freq_low: float = 0.0, freq_high: float = 1.0,
              count_low: int = 1, count_high: int = 3,
              width: float = 0.05) -> torch.Tensor:
    """Notch ``count ∈ [count_low, count_high]`` random bands per row of
    ``sig`` [B, T] (:func:`draw_drop_freq` then :func:`apply_drop_freq`)."""
    draws = draw_drop_freq(sig.shape[0], generator, freq_low=freq_low,
                           freq_high=freq_high, count_low=count_low,
                           count_high=count_high)
    return apply_drop_freq(sig, draws, width=width)


def draw_drop_chunk(batch: int, generator: torch.Generator, *,
                    length_low: int = 1, length_high: int = 5,
                    count_low: int = 1000, count_high: int = 2000) -> dict:
    """DropChunk's draws for ``batch`` rows, on the generator's device:
    ``counts`` [B] in [count_low, count_high], chunk ``lens`` [B,
    count_high] in [length_low, length_high] and start fractions ``u``
    [B, count_high] uniform in [0, 1)."""
    dev = generator.device
    counts = torch.randint(count_low, count_high + 1, (batch,),
                           generator=generator, device=dev)
    lens = torch.randint(length_low, length_high + 1, (batch, count_high),
                         generator=generator, device=dev)
    u = torch.rand(batch, count_high, generator=generator, device=dev)
    return {"counts": counts, "lens": lens, "u": u}


def drop_chunk_mask(T: int, draws: dict,
                    lengths: torch.Tensor | None = None,
                    device=None) -> torch.Tensor:
    """[B, T] bool, True inside a dropped chunk. A chunk starts at
    ``floor(u · max(valid - len, 1))`` and ends at most at the row's valid
    length (``lengths``, [B] samples, or T). Built as +1/−1 boundary counts
    scattered into T + 1 slots, the last of which takes the inactive
    candidates and is dropped, then a cumulative sum: O(count + T)."""
    counts = draws["counts"].to(device)
    lens = draws["lens"].to(device=device, dtype=torch.int32)
    u = draws["u"].to(device=device, dtype=torch.float32)
    B, n_cand = lens.shape
    valid = (torch.full((B,), T, device=device) if lengths is None
             else torch.as_tensor(lengths, device=device)).to(torch.int32)
    max_start = torch.clamp(valid[:, None] - lens, min=1)
    starts = (u * max_start.to(torch.float32)).to(torch.int32)
    active = torch.arange(n_cand, device=device)[None, :] < counts[:, None]
    ends = torch.minimum(starts + lens, valid[:, None])
    inc = torch.zeros(B, T + 1, dtype=torch.int32, device=device)
    one = torch.ones_like(starts)
    inc.scatter_add_(1, torch.where(active, starts, T).long(), one)
    inc.scatter_add_(1, torch.where(active, ends, T).long(), -one)
    return torch.cumsum(inc[:, :T], dim=1) > 0


def apply_drop_chunk(sig: torch.Tensor, draws: dict,
                     lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Zero the drawn chunks of ``sig`` [B, T] (:func:`drop_chunk_mask`)."""
    dropped = drop_chunk_mask(sig.shape[1], draws, lengths, sig.device)
    return torch.where(dropped, torch.zeros((), dtype=sig.dtype,
                                            device=sig.device), sig)


def drop_chunk(sig: torch.Tensor, generator: torch.Generator,
               lengths: torch.Tensor | None = None, *,
               length_low: int = 1, length_high: int = 5,
               count_low: int = 1000, count_high: int = 2000) -> torch.Tensor:
    """Zero ``count ∈ [count_low, count_high]`` random chunks of ``length ∈
    [length_low, length_high]`` samples in each row of ``sig`` [B, T],
    inside the valid region ``lengths`` ([B] samples)."""
    draws = draw_drop_chunk(sig.shape[0], generator, length_low=length_low,
                            length_high=length_high, count_low=count_low,
                            count_high=count_high)
    return apply_drop_chunk(sig, draws, lengths)


class Augmenter:
    """The recipe's chain from its config keys: DropFreq then DropChunk,
    kept per row where a ``augment_prob`` coin lands (the reference's
    Augmenter, ``asr.yaml:78-93``). ``draw`` makes every random number of a
    batch; ``apply`` takes them; calling it does both."""

    def __init__(self, cfg: dict):
        self.prob = float(cfg.get("augment_prob", 0.75))
        self.freq = dict(freq_low=float(cfg.get("drop_freq_low", 0.0)),
                         freq_high=float(cfg.get("drop_freq_high", 1.0)),
                         count_low=int(cfg.get("drop_freq_count_low", 1)),
                         count_high=int(cfg.get("drop_freq_count_high", 3)))
        self.width = float(cfg.get("drop_freq_width", 0.05))
        self.chunk = dict(length_low=int(cfg.get("drop_length_low", 1)),
                          length_high=int(cfg.get("drop_length_high", 5)),
                          count_low=int(cfg.get("drop_count_low", 1000)),
                          count_high=int(cfg.get("drop_count_high", 2000)))

    def draw(self, batch: int, generator: torch.Generator) -> dict:
        """``{"freq": …, "chunk": …, "keep": [B, 1] bool}``."""
        keep = torch.rand(batch, 1, generator=generator,
                          device=generator.device) < self.prob
        return {"freq": draw_drop_freq(batch, generator, **self.freq),
                "chunk": draw_drop_chunk(batch, generator, **self.chunk),
                "keep": keep}

    def apply(self, sig: torch.Tensor, draws: dict,
              lengths: torch.Tensor | None = None) -> torch.Tensor:
        aug = apply_drop_freq(sig, draws["freq"], width=self.width)
        aug = apply_drop_chunk(aug, draws["chunk"], lengths)
        return torch.where(draws["keep"].to(sig.device), aug, sig)

    def __call__(self, sig: torch.Tensor, generator: torch.Generator,
                 lengths: torch.Tensor | None = None) -> torch.Tensor:
        return self.apply(sig, self.draw(sig.shape[0], generator), lengths)


def build_augmenter(cfg: dict) -> Augmenter:
    """The augmentation chain of a recipe config (``augment_prob``,
    ``drop_freq_*``, ``drop_length_*``, ``drop_count_*``)."""
    return Augmenter(cfg)
