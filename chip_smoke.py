#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``audiocodecs_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``/usr/local/cuda``) and no network; it imports nothing
of JAX or of ``audiocodecs_tpu``. Phases, each of which exits non-zero when
it fails:

1. card: name and power limit (``nvidia-smi``);
2. build: every kernel of the main path, one ``nvcc`` each, all at once,
   and beside it ``nvcc -Xptxas -v`` on the LSTM kernel (registers and
   spills of each of its instances);
3. kernel 1, the LSTM recurrence, against its plain version at the main
   path's shape (T=750, B=8, H=512), a ragged one, a batch split over
   several launches, H=1024, one step (T=1), SpeechTokenizer's 10 s LSTMs
   (T=500, H=1024, B=8 and 1), one EnCodec streaming chunk (T=6, B=8)
   and EnCodec-48k's layer over 88 windows (T=150, B=88, three launches,
   and its launch shapes B=32 and 24), the wide instance (H > 1024) at
   BigCodec's 10 s layers (T=800, H=1536, B=8 and 1), X-Codec 2.0's
   (T=500, H=1536, B=8, timed beside its plain version and ``nn.LSTM``),
   the downstream probes' width (T=150, B=4, H=128, timed beside its plain
   version, the port's layer and ``nn.LSTM``), a ragged shape, 20
   rows over three launches, T=1 and H=1088, and two pairs of launches
   back to back; timings at B and at B=1 (per step) at the main shape,
   H=1024, T=1, T=500, T=6, T=150 (B=32, 24) and T=800 at H=1536
   (``time_lstm``: a call, the
   kernel's own device time, and at T=1 calls queued back to back) with
   each one's bound, the kernel's registers, spill and shared bytes;
   ``nn.LSTM`` beside the port's bidirectional layer (T=500, B=8, H=1024),
   beside one streaming chunk's call, beside the 48k layer (B=32, 24,
   88) and beside the wide instance (T=800, H=1536, B=8 and 1); and one
   inter-SM hand-off, the latency floor of a step;
4. kernel 2, the fused SEANet residual block, against its plain version at
   the main path's four (C, T) shapes (B=8), a ragged one and its widest
   tile (C=384), with timings of the kernel on weights packed once (as the
   model calls it), the time of one pack, the model's unfused cuDNN path,
   and the kernel's registers, spills, shared bytes and blocks an SM;
5. the packed SEANet block entry point (channel-last, zero causal pad),
   which launches kernel 2, against its plain version at EnCodec's two
   narrow widths and a ragged shape, with timings;
6. kernel 3, the fused DAC residual unit, against its plain version (which
   the model's unfused units run) at the DAC-44.1k decoder's six
   (C, T, dilation) shapes, ragged ones (C and T off the kernel's chunk
   and tile), the widest window and ones shorter than their padding, with
   timings of the kernel on weights packed once (as the model calls it),
   the time of one pack, and the kernel's registers, shared bytes and
   blocks an SM; then at BigCodec-16k's nine decoder units for
   B = 8 x 10 s (C = 192, 96, 48 at d = 1, 3, 9) and BiCodec-16k's six
   (C = 192 and 96) beside the cuDNN path;
   then each of its other forms (exact with the polynomial snake; one bf16
   pass on the tensor cores with the sin or the polynomial snake, on fp32
   or bf16 activations) at both sets of shapes: held against its plain
   version (the default form one rounding point at a time,
   ``ops/dac_resunit.py::default_errors``), timed beside the plain version
   and the model's unfused unit in the same form, with its bound at
   989 TFLOP/s bf16, registers, spill and shared bytes: a kernel row each;
7. the EnCodec path as a small server: EnCodec-24 kHz, 8 codebooks, seeded
   random weights, three requests through ``sig_to_toks`` → ``toks_to_sig``
   with the kernel launches and kernel 2's weight packs counted, parity
   against the same weights on the CPU, then the warm roundtrip time, peak memory and the device time by
   kernel over one roundtrip (torch.profiler);
8. the DAC path the same way: DAC-44.1 kHz, 9 codebooks, two 10 s requests
   and one B = 2 ragged request, six kernel-3 launches a decode, the fused
   units' weights packed on the first decode only;
9. SpeechTokenizer-16 kHz the same way: two B = 8 x 10 s requests and one
   B = 1 ragged one, six kernel-1 launches a roundtrip (the encoder's
   bidirectional LSTM, 2 layers x 2 directions, and the decoder's 2
   layers), parity on the ragged request and two rows of the first;
10. EnCodec-24 kHz streaming: B = 8 x 10 s in 125 chunks of 6 frames
   (80 ms) through ``encode_chunk`` then ``decode_chunk``, four kernel-1
   launches a chunk, against the CPU path's stream on two rows, with the
   median and p90 chunk time and the streaming RTF;
11. Mimi-24 kHz, 8 codebooks: the batch path as in 9 (no kernel launches),
   then the first request streamed in one-frame chunks (80 ms) against the
   card's batch path, with the chunk times;
12. WavTokenizer-24 kHz as in 9 (B = 8 x 10 s): two kernel-1 and four
   kernel-2 launches a roundtrip (the encoder), the Vocos head (768 wide,
   12 blocks) on library calls, profiled alone too;
13. EnCodec-24 kHz with the Vocos head (K = 8, bandwidth id 2) the same
   way: two kernel-1 and four kernel-2 launches a roundtrip;
14. EnCodec-48 kHz chunked (1 s windows, 1 % overlap, normalized,
   non-causal): B = 8 x 10 s is 88 windows, twelve kernel-1 launches a
   roundtrip (32 rows a launch), no kernel 2; parity on a B = 1 x 2.97 s
   request (3 windows);
15. PAST-16 kHz as in 9: four kernel-1 and eight kernel-2 launches a
   roundtrip, then the first request streamed in 80 ms chunks (4 frames)
   as in 10;
16. BigCodec-16 kHz as in 9 (published width, the encoder's 1024-d output
   as features): four kernel-1 launches a roundtrip on the wide instance
   (H = 1536, one launch a layer at B = 8) and nine kernel-3 launches (the
   decoder's units of C = 192, 96, 48), the fused units packed on the
   first decode only;
17. the serving tiers (``audiocodecs_tpu_torch/serving.py``): DAC-44.1k
   in its latency and fast tiers at B = 1 and its throughput tier (bf16
   activations, polynomial snake) at B = 4 and 8, then in the unit's three
   forms that no preset selects at B = 1 (six B4 launches a decode in the
   tier's form), and BigCodec-16k's balanced tier at B = 8 x 10 s (four
   wide kernel-1 and nine bf16-poly B4 launches a roundtrip): tokens equal
   to the exact tier's bit for bit, the waveform's rms and max deviation
   from the exact tier, and the tier's warm roundtrip beside the exact
   tier's; for the presets' tiers also the decode of one row's first
   second on the card against the CPU path of the same tier (the exact
   forms within 1e-4 of max|sig|; where the tier rounds to bf16, every
   decoder residual unit fed its CPU twin's input within a quarter of the
   unit's move off exact fp32, the exact unit reading more, and end to end
   rms no larger than the tier's move), and at B = 8 the throughput tier
   with its units unfused;
18. the server: ``CodecServer`` (``audiocodecs_tpu_torch/examples/
   serve.py``) over BigCodec-16k and EnCodec-24k by registry name (each
   exact, and in its balanced tier as the entry point builds it),
   buckets (1, 2, 5, 10) s, 8 rows a batch, 5 ms to gather, the JAX
   ``examples/serve.py`` main()'s 16 requests at once: every reply of its
   request's length, finite and equal, bit for bit, to the row of
   ``codec.roundtrip`` on its padded batch, one roundtrip's launches a
   batch; requests served, audio and wall seconds, x real time, latency
   p50/p90;
19. EnCodec-24 kHz training at its published width (seeded random
   weights, 8 codebooks, EMA codebooks, the spectral term live from the
   second step, Adam at 3e-4 with betas (0.5, 0.9)): first each kernel's
   autograd Function (kernel forward, backward recomputed through the
   plain version) against the plain version's autograd on the card, and
   each kernel's forward against its plain version, at the training
   path's shapes; step 1 on a B = 2 x 1 s batch against the CPU path
   (losses, every gradient, tokens, the EMA codebooks); then eight steps on
   B = 8 x 1 s synthetic batches, four kernel-1 and eight kernel-2 launches
   a step, every encoder and decoder gradient finite and nonzero, the warm
   step's time, audio seconds trained a wall second, peak memory, and one
   profiled step taken apart by the step's own ranges: each part's time,
   the kernels each part launched, by the wrappers' counters read at the
   ranges' edges and in the profile's device window of each part (all in
   the forward, none in the backward, by both), and the time of the
   kernels' recompute inside the backward. Every profile follows 256
   spin-kernel launches (``PROFILE_WARMUP_LAUNCHES``);
20. kernel 2's one-pass form (one bf16 pass on the tensor cores) at the
   EnCodec-24k decoder's four (C, T) shapes (B = 8 x 10 s), on fp32 and on
   bf16 operands, and the packed entry point in the form at (32, 240000)
   and (64, 120000): each held to its plain version one rounding point at
   a time (``ops/seanet_resblock.py::default_errors``), timed on weights
   packed once beside its plain version, the block unfused in bf16 and in
   fp32 on bf16-rounded operands, with its bound at 989 TFLOP/s bf16 or
   the HBM rate, registers, spills and shared bytes: a kernel row each;
21. the EnCodec-style serving tier (bf16 decoder activations) of
   EnCodec-24k, PAST-16k (4 kernel-1, 4 exact and 4 one-pass bf16 kernel-2
   launches a roundtrip), Mimi-24k (none) and SpeechTokenizer-16k (6
   kernel-1) at B = 8 x 10 s beside the exact tier, as in 17: tokens equal,
   the move off exact, the first second of one row against the CPU path
   of the same tier (rms no more than the move), both roundtrips;
22. the certify run: EnCodec-24k's encoder exact and at one bf16 pass
   (``encode_precision="default"``, 4 one-pass fp32 kernel-2 launches an
   encode) at B = 4 x 10 s through ``quant/certify.py::certify_codec``:
   the certified share, the real token match, and a failure if any
   certified frame's tokens differ from the exact path's;
23.-28. the zoo's first six families at their published widths, each as in
   9 (two B = 8 x 10 s requests and one ragged B = 1; parity on the ragged
   request and the first rows of the first; the warm roundtrip, RTF, peak
   memory, stages and the device time by group): AudioDec-24k,
   HILCodec-24k (then streamed through ``encode_chunk`` in 80 ms chunks,
   its tokens against its batch encode, the chunk times), NanoCodec-22.05k,
   X-Codec 2.0-16k (two wide kernel-1 launches a roundtrip: the acoustic
   encoder's LSTM at H = 1536; parity on one row of the first request;
   how near its FSQ's half-steps the card's latents fall, beside the
   card-CPU gap),
   StableCodec-16k and MagiCodec-16k; no other kernel launches;
29. the zoo's one-pass decoders (``decode_precision="default"`` at fp32
   activations): HILCodec-24k, StableCodec-16k, X-Codec 2.0-16k and
   MagiCodec-16k, on the weights of 24, 26-28, each decode a B = 1 x 10 s
   token grid on the card and on the CPU in the form: the move off exact
   above 0, the card within it;
30.-33. the WavLM-tower families at their published widths and full
   depth, as in 23: WavLM+K-means-16k and DyCAST-16k (no kernel launch;
   then each one's balanced tier, a bf16 SEANet vocoder, beside its exact
   one as in 21; DyCAST's boundary margin: how near its threshold the
   card's logits fall, beside the card-CPU gap, its segments against the
   capacity, and a full random grid decoded against the CPU),
   FocalCodec-16k (no kernel launch; its sign margin) and BiCodec-16k
   (six kernel-3 launches a roundtrip in the exact form, the generator's
   units at C = 192 and 96, packed on the first decode only; the global
   tokens' FSQ margin); kernel 3 is also timed at BiCodec's six unit
   shapes in 6;
34. SemantiCodec-16k at its published widths (AudioMAE ViT-B, two 8192
   codebooks at 50 Hz, the LDM UNet with context 1536, the VAE and the
   1024-channel HiFi-GAN, 50 DDIM steps): B = 8 x 10 s and B = 1 x 15 s
   (two windows, the crossfade); no kernel launch; the decode
   deterministic; parity against the CPU path (tokens, features, one UNet
   call at t = 981, the 15 s request decoded at 2 steps within the larger
   of 1e-4 and the fp32 gap of ``tools/semanticodec_fp32_gap.py``); the
   warm roundtrip, its stages with their FLOPs and bounds, the profile
   (of a twin at 5 DDIM steps: the profiler's bookkeeping of the 50-step
   roundtrip's 123,059 launches took 94 s);
   the balanced tier (bf16 UNet, VAE and vocoder): tokens equal, its move
   off exact at 50 and 2 steps, the card within √2 x the move of the CPU
   at 2 steps (two bf16 decodes are independent draws of the tier's error;
   the card against itself in another batch beside), its roundtrip beside
   the exact one; then WavLM+K-means-16k with
   its HiFi-GAN vocoder, one B = 1 x 10 s roundtrip against the CPU.
35. checkpoint loading: EnCodec-24k, DAC-44.1k, SpeechTokenizer-16k,
   PAST-16k and BigCodec-16k at their published widths, each on a seeded
   state dict in its released checkpoint's layout (``transformers``' for
   EnCodec and DAC, the vendor's for the others) converted by
   ``audiocodecs_tpu_torch/convert/`` and loaded through the registry's
   class: the conversion and the load timed, the two request shapes of the
   family's phase (its long rows at 5 s, ``LOADING_SECONDS``) with the
   random-init phases' launches a roundtrip, the
   ragged request and the rows of the first that the family's phase
   compares (all of EnCodec's B = 8, DAC's B = 1, rows 0-1 elsewhere)
   against the CPU path on the same weights as in 9, the warm roundtrip;
   then DAC-44.1k on the same draw at unit gain (its closing 1x1s not cut
   to a tenth): each B4 unit fed the CPU unit's input within 1e-4 of the
   CPU unit, both beside float64, and the decode's gap to the CPU path
   beside that of the card's unfused (kernel-free) decode.
36. the rest of the zoo loaded: X-Codec 2.0-16k (B1 wide 2 a roundtrip)
   and BiCodec-16k (B4 6; its XLSR tower a second file) as 35 drives its
   five, on their phases' requests (the long rows at 5 s), shapes and
   parity rows, with their
   FSQ margins; then StableCodec, NanoCodec, AudioDec, MagiCodec,
   FocalCodec, HILCodec (whole towers), DyCAST, WavLM+K-means with its
   HiFi-GAN vocoder and SemantiCodec (assembled from its five files) at
   their published widths, converted and loaded (both timed), one short
   request each (B = 1 x 2 s, SemantiCodec's 10.24 s window at 2 DDIM
   steps): no launch, tokens equal to the CPU path's, the decode within
   its family's limit, the token margins; NanoCodec's HiFi-GAN units'
   closing convs drawn at a tenth, and NanoCodec at unit gain beside
   float64. The checkpoints of 35 and 36 are drawn on a host thread from
   the start (``prefetch_checkpoints``), while the kernels build.
37. long audio: ``utils/windowed.py::windowed_reconstruct`` on EnCodec-24k
   at B = 1 x 25 s in 10 s windows (three roundtrips: 12 kernel-1 and 24
   kernel-2 launches) against the CPU path on the same weights (within
   1e-4 of max|sig|); the native WAV writer and reader (``csrc/wavio.cc``,
   built with ``g++`` on the card's host) against the ``wave`` path, bytes
   and arrays equal; the ``reconstruct`` (EnCodec-24k, 4 kernel-1 and 8
   kernel-2 launches) and ``stream`` (Mimi-24k, streamed tokens equal to
   the batch encode's, no launch) examples' ``main()``;
38. the SR evaluation: the ``sweep_sr`` example's ``main()`` over its four
   default codecs at the registry's rates and published widths
   (EnCodec-24k, DAC-16k, Mimi-24k, SpeechTokenizer-16k) on the synthetic
   corpus of ``hparams/datasets/synthetic.yaml``: launches a roundtrip
   (EnCodec 4 kernel-1 and 8 kernel-2, DAC 6 kernel-3, SpeechTokenizer 6
   kernel-1, Mimi none; a roundtrip a batch and 3 (lo + hi) a batch shape
   for the timer), each codec's iRTF, RTF and battery; the summary keys against
   the CPU run's, and EnCodec's per-utterance metrics against ``run_sr(...,
   device="cpu")`` on the same weights (SI-SNR within 0.01 dB, MelD and
   STFTD within 1e-3 relative, STOI 1e-3, PESQ 0.02, DNSMOS 1e-3) with
   its tokens (token_match ≥ 0.999); the DNSMOS time an utterance. Each
   shape is timed by the slope between two chain lengths (``rtf_reps``:
   3 (lo + hi) encodes and decodes a shape); the shape timers then run
   once more on each codec and both passes' iRTF are printed; the sweep
   runs with ``use_profiler`` (1 s), and each codec's ``profiler.txt`` and
   summary ``"profiler"`` key are checked;
39. the metric models at their published widths on seeded weights and
   synthetic vocabularies of each model's size (Whisper's special tokens
   at their ids), on the synthetic test split: UTMOS22 strong
   (wav2vec2-base tower, BiLSTM H = 512 through kernel 1, two launches an
   utterance), unbucketed and bucketed, against the CPU path (1e-4 of
   max|score|) and ``bilstm_masked``'s valid frames against ``bilstm``
   (1e-6 relative); the WavLM x-vector (embeddings 1e-4 of max|e|, SpkSim
   1e-5); Whisper large-v3 at full depth (B = 3 x 30 s: encode ms, ms a
   decode step, dWER and dCER end to end) and at 2 + 2 layers against
   the CPU (log-mel and encoder states 1e-4 relative, teacher-forced
   logits 1e-4 of max, greedy ids identical, the least top-2 margin
   beside the largest logit gap); GPT-2 large at full depth (NLL ms, PPL)
   and at 2 layers against the CPU (1e-4 relative); the profiler on
   EnCodec-24k at 1, 2 and 4 s (``gflops`` within 1 % of the CPU path's,
   times, peak memory, 4 kernel-1 and 8 kernel-2 launches a roundtrip).
40. the downstream trainer on EnCodec-24k's seeded weights and the
   synthetic corpus of ``hparams/datasets/synthetic.yaml``: (a)
   ``run_classification`` at ``ic.yaml``'s widths for 2 epochs, with
   kernel 1's launches at H = 512 (the codec's encoder, uncached batches
   only) and at H = 128 (the probe, one a forward) and kernel 2's counted
   against the batches; then 3 train steps on the card against the CPU
   from one init and the run's cached tokens (loss 1e-5 relative, params
   1e-4), the probe's gradient non-zero and within 1e-4 of the CPU's, and
   one batch's tokens against the CPU codec (token_match ≥ 0.999); (b)
   ``run_asr`` at ``asr.yaml``'s widths (BPE) for 1 epoch: both LSTM
   directions launch kernel 1, the train loss is finite, one batch's CTC
   loss within 1e-5 of the CPU's; (c) the Llama decoder at ``slm.yaml``'s
   widths (d 256, 4 layers, 4 heads, 2 KV heads, FFN 688; K = 8,
   C = 1024): logits 1e-4 relative of the CPU's, 32 greedy tokens equal,
   and the time of a decode step.
41. the rest of the downstream recipes on EnCodec-24k's seeded weights
   and the synthetic corpus, at the task YAMLs' widths, 1 epoch each:
   (a) ``run_se`` with the Conformer (d 256, 4 layers, k 31), every batch
   encoded again each pass (noisy + clean, 2B rows a call); (b)
   ``run_ss`` (mixture + 2 sources, 3B rows a call); (c) ``run_slm`` with
   ``slm.yaml``'s Llama, generation and ``consistency_eval``; (d)
   ``run_tts`` (char tokens); each with kernel 1's and kernel 2's launches
   against the batches (rows above ``max_batch(512)`` split into serial
   launches), then 3 train steps on the card against the CPU from one
   init (the first step's gradients 1e-4 of each leaf's largest, losses
   1e-5 relative; after the steps each leaf's largest gap within 2e-3 of
   the leaf's largest element and the share of elements within 1e-4 of
   their leaf's largest ≥ 0.99999: Adam's first steps turn rounding in
   near-zero gradients into step-sized moves on either device; beside
   them, the leaves on which the CPU's last step left out would fail
   these limits) with the card's step ms and one more
   step's device busy time and idle share (torch.profiler), one
   batch's argmax tokens of the card model against its weights on the CPU
   (SE, SS: token_match ≥ 0.999) or its greedy continuation (SLM, TTS:
   equal) and a decode step's time; (e) ``run_vc`` at ``max_pairs: 2`` on
   EnCodec-24k (``acoustic_splice``), BigCodec-16k (``knn_feats``,
   ``latent: false``: kernel 1 wide and kernel 3) and BiCodec-16k
   (``global_token_swap``: kernel 3), with the launches against the
   pairs and a pair's time, then each pair converted on the CPU on the
   card codec's weights (token grids equal, converted waveforms within
   1e-4 of max|sig|).
   Phases 37-41 write under the git-ignored ``results/chip_smoke/``.
42. the parallel layer (``audiocodecs_tpu_torch/parallel/``) at world size
   1 over NCCL (a file store in a temporary directory, a ``(data, model)``
   mesh of (1, 1)): (a) two steps of the sharded EnCodec-24k codec step at
   B = 8 x 1 s (weights all-gathered before the forward, 4 kernel-1 and 8
   kernel-2 launches a step) against two steps of the one-device step on
   the same weights (losses 1e-6 relative, each leaf after the steps
   within 1e-5 of the leaf's largest, or phase 41's limits); (b)
   data-parallel serving of EnCodec-24k at B = 8 x 1 s (tokens equal to
   the one-device path's, waveform within 1e-5 of max; 4 and 8 launches);
   (c) the SLM steps at ``slm.yaml``'s widths, each against the unsharded
   step from one init over two steps (losses 1e-6 relative, first-step
   gradients 1e-5 of each leaf's largest): Megatron at mp = 1 with remat
   on, GPipe with S = 1 and M = 2, and a 4-expert switch-MoE decoder with
   expert parallelism on a model axis of 1; each step's time; (d)
   ``dryrun_multichip(4, device="cpu")``, the multi-rank math on the
   machine's CPU over gloo, with its summary line.

The JSON line of every kernel's numbers (``{"kernels": [...]}``) and the
card line come before the last line, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

# Published peaks (NVIDIA data sheets): fp32 on CUDA cores and HBM rate.
_PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}
# main path, ragged, a batch split over several launches, the kernel's
# widest H, one step (lstm_cell_step); SpeechTokenizer's 10 s LSTMs at B = 8
# and B = 1, one 80 ms chunk of EnCodec streaming; EnCodec-48k's 88 windows
# of 150 frames (launches of 32, 32 and 24 rows); then the wide instance:
# BigCodec's 10 s LSTMs at B = 8 and 1, ragged, 20 rows over three launches
# of 8, one step, and a width off its 12 units a block
LSTM_SHAPES = [(750, 8, 512), (257, 3, 512), (40, 100, 512), (750, 8, 1024),
               (1, 8, 512), (500, 8, 1024), (500, 1, 1024), (6, 8, 512),
               (150, 32, 512), (150, 24, 512), (150, 88, 512),
               (800, 8, 1536), (800, 1, 1536), (257, 3, 1536),
               (40, 20, 1536), (1, 8, 1536), (33, 5, 1088), (500, 8, 1536),
               (150, 4, 128)]
# each also timed at B = 1
LSTM_TIMED = [(750, 8, 512), (750, 8, 1024), (1, 8, 512), (500, 8, 1024),
              (6, 8, 512), (150, 32, 512), (150, 24, 512), (800, 8, 1536),
              (500, 8, 1536), (150, 4, 128)]
# the downstream probes' recurrence (hparams/tasks/ic.yaml, asr.yaml:
# probe_hidden 128) over a 2 s utterance at 75 Hz, B = 4
LSTM_PROBE = (150, 4, 128)
LSTM_WIDE = (800, 8, 1536)  # BigCodec-16k's LSTM layer at B = 8 x 10 s
LSTM_XCODEC2 = (500, 8, 1536)  # X-Codec 2.0-16k's encoder LSTM, B = 8 x 10 s
RESBLOCK_SHAPES = [(8, 32, 240000), (8, 64, 120000), (8, 128, 30000),
                   (8, 256, 6000)]
# ragged (T off the 4-sample vectors) and the widest tile
RESBLOCK_EXTRA = [(3, 64, 1001), (2, 384, 4096)]
PACKED_SHAPES = [(8, 32, 240000), (8, 64, 120000)]  # (B, C, T)
PACKED_RAGGED = (3, 64, 1001)
# the DAC-44.1k decoder's fused units for B = 1 x 10 s: (B, C, T, dilation)
DAC_UNIT_SHAPES = [(1, 192, 220416, d) for d in (1, 3, 9)] + [
    (1, 96, 440832, d) for d in (1, 3, 9)]
# ragged; T < 6d; C and T off the chunk and the tile; the widest window
DAC_UNIT_EXTRA = [(3, 96, 1001, 9), (2, 8, 20, 9), (1, 200, 4099, 9),
                  (1, 256, 4097, 9)]
# BigCodec-16k's decoder units for B = 8 x 10 s (the nine of a decode)
DAC_UNIT_BIGCODEC = [(8, C, T, d) for C, T in ((192, 40000), (96, 80000),
                                               (48, 160000))
                     for d in (1, 3, 9)]
# BiCodec-16k's generator units on the fused unit for B = 8 x 10 s (the six
# of a decode; its 768- and 384-channel units run unfused)
DAC_UNIT_BICODEC = [(8, C, T, d) for C, T in ((192, 80000), (96, 160000))
                    for d in (1, 3, 9)]
# the Functions' gradients at the training step's shapes: (T, B, H) for B1,
# (B, C, T) for B2 (EnCodec-24k's four blocks at B = 8 x 1 s) and B3, and
# (B, C, T, dilation) for B4
TRAIN_GRAD_LSTM = (75, 8, 512)
TRAIN_GRAD_BLOCKS = [(8, 32, 24000), (8, 64, 12000), (8, 128, 3000),
                     (8, 256, 600)]
TRAIN_GRAD_PACKED = (8, 32, 24000)
TRAIN_GRAD_UNIT = (1, 192, 22050, 1)
TRAIN_B, TRAIN_STEPS, TRAIN_TIMED = 8, 8, slice(2, 8)  # steps 3-8 timed
# the DAC unit's forms besides the exact sin one (ops/dac_resunit.py FORMS):
# name → (precision, snake_poly, activations' dtype name)
_NEW_FORMS = {"exact_poly": ("exact", True, "float32"),
              "default_f32": ("default", False, "float32"),
              "default_poly_f32": ("default", True, "float32"),
              "default_bf16": ("default", False, "bfloat16"),
              "default_poly_bf16": ("default", True, "bfloat16")}
BF16_PEAK = 989e12  # dense bf16 on the tensor cores (H100 SXM data sheet)
# the SEANet block's one-pass form by entry point and operands' dtype (the
# rows and launch counts of B2's and B3's "default" form)
B2_FORMS = ("seanet_resblock_default_f32", "seanet_resblock_default_bf16",
            "seanet_resblock_packed_default_f32",
            "seanet_resblock_packed_default_bf16")
# the EnCodec-style tier's certify run: EnCodec-24k's encoder at B = 4 x 10 s
CERTIFY_B, CERTIFY_SECONDS = 4, 10.0
# A one-pass tier's residual unit on the card, fed the CPU path's input, at
# most this share of the unit's own move off exact fp32 away from the CPU
# path's output (tools/tier_divergence.py reads at most 0.04 between two
# conv implementations on the CPU; exact fp32 in place of the tier reads 1).
UNIT_SHARE = 0.25


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peaks) -> tuple[float, str]:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_card(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return name, card, _PEAKS["pcie" if "PCIe" in name else "sxm"]


def phase_build():
    from audiocodecs_tpu_torch.ops import _build

    # ptxas's report on the LSTM kernels (registers, spills), beside the build
    cubin = _build.BUILD_DIR / "lstm_recurrence.cubin"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS[:4], "-cubin",
         "-Xptxas", "-v", "-o", str(cubin),
         str(_build.CSRC / "lstm_recurrence.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        secs = _build.build_all()
    except RuntimeError as e:
        ptxas.kill()
        fail(f"kernel build: {e}")
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} s")
    out, _ = ptxas.communicate(timeout=600)
    if ptxas.returncode != 0:
        fail(f"nvcc -Xptxas -v failed:\n{out}")
    for line in ptxas_report(out):
        log(line)


def ptxas_report(out: str) -> list:
    """One line per kernel of ``nvcc -Xptxas -v``: its template arguments
    (units a block, k rows a thread), registers and spill bytes."""
    import re

    lines, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"(lstm_(?:recurrence_kernel_wide|recurrence_kernel"
                          r"|handoff_probe_kernel))(ILi(\d+)E(?:Li(\d+)E)?)?",
                          m.group(1))
            name = t and t.group(1)
            if t and t.group(4):
                name += " U={} KP={}".format(*t.group(3, 4))
            elif t and t.group(3):
                name += f" R={t.group(3)}"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"ptxas {name}: {regs.group(1) if regs else '?'} "
                         f"registers; {spill}")
            name = None
    return lines


def _lstm_inputs(torch, gen, T, B, H, dev):
    s = 1.0 / math.sqrt(H)
    gx = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(dev)
    w_hh = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * s).to(dev)
    h0 = (torch.randn(B, H, generator=gen) * 0.1).to(dev)
    c0 = (torch.randn(B, H, generator=gen) * 0.1).to(dev)
    return gx, w_hh, h0, c0


def _lstm_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def time_lstm(torch, ops, T, B, H) -> dict:
    """``ops.lstm_recurrence`` (``ops``: the ``lstm_recurrence`` module of
    the checkout under test) at (T, B, H) and at B = 1, on inputs seeded by
    the shape alone, so that two checkouts timed in turns see the same
    work. Each is first held against ``ops.lstm_recurrence_reference``
    (limit 1e-5 absolute). Then: ms a call (CUDA events around the call, so
    the host's launch path counts), the kernel's own device time a launch
    (torch.profiler, the host left out), and at T = 1 ms a call over 50
    calls queued back to back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audiocodecs_tpu_torch.nn.layers import exact_fp32

    out = {"T": T, "B": B, "H": H, "max_abs_err": 0.0}
    for pre, b in (("", B), ("b1_", 1)):
        gen = torch.Generator().manual_seed(T * 100003 + b * 1009 + H)
        args = _lstm_inputs(torch, gen, T, b, H, "cuda")

        def call():
            return ops.lstm_recurrence(*args)

        with torch.inference_mode(), exact_fp32():
            err = _lstm_err(call(), ops.lstm_recurrence_reference(*args))
            if not err <= 1e-5:
                fail(f"lstm_recurrence disagrees with its plain version at "
                     f"T={T} B={b} H={H}: {err}")
            ms = cuda_ms(torch, call)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            dev_us = [_device_us(e) / e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and "lstm_recurrence_kernel" in e.key]
            out.update({f"{pre}ms": ms, f"{pre}per_step_us": ms / T * 1e3,
                        f"{pre}device_us": dev_us[0] if dev_us else None})
            if T == 1:
                def queued():
                    for _ in range(50):
                        call()
                out[f"{pre}queued_ms"] = cuda_ms(torch, queued, reps=5) / 50
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def _lstm_times(e: dict) -> str:
    def one(pre):
        s = (f"kernel_ms={e[pre + 'ms']:.4f} "
             f"per_step_us={e[pre + 'per_step_us']:.3f} device_us="
             + ("not measured" if e[pre + "device_us"] is None
                else f"{e[pre + 'device_us']:.2f}"))
        if pre + "queued_ms" in e:
            s += f" queued_ms={e[pre + 'queued_ms']:.4f}"
        return s
    return f"{one('')}; at B=1: {one('b1_')}"


def phase_lstm(torch, peaks):
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.ops import lstm_recurrence as ops
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        handoff_us, lstm_recurrence, lstm_recurrence_info,
        lstm_recurrence_reference)

    gen = torch.Generator().manual_seed(1)
    dev = "cuda"
    worst, worst_wide, per_shape, wide_args = 0.0, 0.0, [], {}

    def check(label, args):
        nonlocal worst
        with torch.inference_mode(), exact_fp32():
            before = lstm_recurrence.launches
            got = lstm_recurrence(*args)
            want = lstm_recurrence_reference(*args)
            torch.cuda.synchronize()
        err = _lstm_err(got, want)
        log(f"lstm_recurrence {label}: max_abs_err={err:.3e} launches="
            f"{lstm_recurrence.launches - before}")
        if not err <= 1e-5:
            fail(f"lstm_recurrence disagrees with its plain version at "
                 f"{label}: {err}")
        worst = max(worst, err)
        return err

    for T, B, H in LSTM_SHAPES:
        args = _lstm_inputs(torch, gen, T, B, H, dev)
        err = check(f"T={T} B={B} H={H}", args)
        if (T, B, H) == LSTM_SHAPES[0]:
            main_args = args
        if H > 1024:
            worst_wide = max(worst_wide, err)
        if (T, H) == (LSTM_WIDE[0], LSTM_WIDE[2]):
            wide_args[B] = args
        if (T, B, H) == LSTM_XCODEC2:
            xcodec2_args = args

    for T, B, H in LSTM_TIMED:
        entry = time_lstm(torch, ops, T, B, H)
        worst = max(worst, entry["max_abs_err"])
        info = lstm_recurrence_info(H, B)
        entry.update(info)
        entry["bound_ms"], entry["bound_by"] = _lstm_bound(T, B, H, peaks)
        entry["b1_bound_ms"] = _lstm_bound(T, 1, H, peaks)[0]
        log(f"lstm_recurrence T={T} B={B} H={H}: {_lstm_times(entry)}; "
            f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']}), at "
            f"B=1 {entry['b1_bound_ms']:.4f}; {json.dumps(info)}")
        per_shape.append(entry)
    main = per_shape[0]
    row = _lstm_main_row(torch, gen, peaks, main_args, main["ms"],
                         main["b1_ms"])
    row.update(_lstm_library(torch, gen))
    # the wide instance's row: BigCodec's layer at B = 8, and at B = 1
    wide = next(e for e in per_shape if (e["T"], e["B"], e["H"]) == LSTM_WIDE)
    wide_row = _lstm_main_row(torch, gen, peaks, wide_args[LSTM_WIDE[1]],
                              wide["ms"], wide["b1_ms"],
                              name="lstm_recurrence_wide")
    at_b1 = _lstm_main_row(torch, gen, peaks, wide_args[1], wide["b1_ms"],
                           wide["b1_ms"], name="lstm_recurrence_wide")
    wide_row.update(
        max_abs_err=worst_wide, device_us=wide["device_us"],
        b1={k: at_b1[k] for k in ("ms", "plain_ms", "library_ms",
                                  "port_layer_ms", "bound_ms", "bound_by")},
        info={B: lstm_recurrence_info(LSTM_WIDE[2], B) for B in (8, 1)})
    # X-Codec 2.0's encoder layer: the kernel against its plain version,
    # the port's layer and nn.LSTM, and its bound
    xc = next(e for e in per_shape if (e["T"], e["B"], e["H"]) == LSTM_XCODEC2)
    at_xc = _lstm_main_row(torch, gen, peaks, xcodec2_args, xc["ms"],
                           xc["b1_ms"], name="lstm_recurrence_wide")
    wide_row["xcodec2"] = {k: at_xc[k] for k in (
        "shape", "ms", "b1_ms", "plain_ms", "library_ms", "port_layer_ms",
        "bound_ms", "bound_by")}
    wide_row["xcodec2"].update(device_us=xc["device_us"],
                               max_abs_err=xc["max_abs_err"])

    # back to back on one stream, different inputs, the exchange's memory
    # reused: at T = 2 a tag left by the first launch is the one the second
    # waits for at its last step, so only the kernel's clear keeps it right
    for T, B, H in ((2, 8, 512), LSTM_SHAPES[0]):
        pair = [_lstm_inputs(torch, gen, T, B, H, dev) for _ in range(2)]
        with torch.inference_mode(), exact_fp32():
            got = [lstm_recurrence(*a) for a in pair]
            want = [lstm_recurrence_reference(*a) for a in pair]
            torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            err = _lstm_err(g, w)
            log(f"lstm_recurrence back-to-back T={T} B={B} H={H} launch "
                f"{i + 1}: max_abs_err={err:.3e}")
            if not err <= 1e-5:
                fail(f"lstm_recurrence back-to-back launch {i + 1} "
                     f"disagrees with its plain version: {err}")
            worst = max(worst, err)

    hand = handoff_us()
    T = LSTM_SHAPES[0][0]
    log(f"lstm_recurrence hand-off: {hand:.4f} us one way between two SMs; "
        f"latency floor T x hand-off = {T * hand / 1e3:.4f} ms at T={T}")
    row.update(max_abs_err=worst, per_shape=per_shape, handoff_us=hand,
               latency_floor_ms=T * hand / 1e3)
    # the probes' width: its bound is the larger of the latency floor and
    # its bytes over HBM (its products over the fp32 peak are less)
    T, B, H = LSTM_PROBE
    probe = row["probe_h128"]
    floor_ms = T * hand / 1e3
    b_ms, b_by = _lstm_bound(T, B, H, peaks)
    probe.update(latency_floor_ms=floor_ms, bytes_or_ops_ms=b_ms,
                 bound_ms=max(floor_ms, b_ms),
                 bound_by="latency" if floor_ms >= b_ms else b_by)
    log(f"lstm probe layer T={T} B={B} H={H}: latency floor "
        f"{floor_ms:.4f} ms, {b_by} {b_ms:.4f} ms, bound_ms "
        f"{probe['bound_ms']:.4f}")
    T = LSTM_WIDE[0]
    wide_row.update(handoff_us=hand, latency_floor_ms=T * hand / 1e3)
    log(f"lstm_recurrence_wide T={T}: latency floor T x hand-off = "
        f"{T * hand / 1e3:.4f} ms")
    return row, wide_row


def _lstm_bound(T, B, H, peaks):
    """Least time for one layer's recurrence: its products over the fp32
    peak, or its bytes (gx, w_hh, ys, h0, c0, h_T, c_T once) over HBM."""
    flops = 2.0 * T * B * H * 4 * H
    nbytes = 4.0 * (T * B * 4 * H + H * 4 * H + T * B * H + 4 * B * H)
    return bound(flops, nbytes, peaks)


def _lstm_library(torch, gen) -> dict:
    """``nn.LSTM`` (cuDNN, TF32 off) beside the port at the slices' shapes:
    one bidirectional layer of SpeechTokenizer's encoder (T=500, B=8,
    H=1024) against the port's (two input projections, two flips, two
    kernel launches); one 80 ms chunk of EnCodec streaming (T=6, B=8,
    H=512) and EnCodec-48k's layer (T=150, H=512, B=88 and the 32 and 24
    rows of its launches) against the kernel call, its plain version and
    the port's layer."""
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.lstm import _layer, bilstm, init_lstm_params
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence, lstm_recurrence_reference)

    def cuda_params(cin, H):
        p = init_lstm_params(gen, 1, cin, H)[0]
        p["b"] = (torch.rand(4 * H, generator=gen) * 2 - 1) / math.sqrt(H)
        return {k: v.to("cuda") for k, v in p.items()}

    def load(ref, p, suffix):
        for name, t in (("weight_ih", p["w_ih"].T), ("weight_hh", p["w_hh"].T),
                        ("bias_ih", p["b"])):
            getattr(ref, f"{name}_l0{suffix}").copy_(t)
        getattr(ref, f"bias_hh_l0{suffix}").zero_()

    out = {}
    T, B, H = 500, 8, 1024
    layer = {"fwd": cuda_params(H, H), "bwd": cuda_params(H, H)}
    # as SEANet hands it over: a [B, C, T] tensor seen as [B, T, C]
    x = (torch.randn(B, H, T, generator=gen) * 0.5).to("cuda").transpose(1, 2)
    xc = x.contiguous()
    ref = torch.nn.LSTM(H, H, 1, batch_first=True, bidirectional=True).to(
        "cuda")
    with torch.inference_mode(), exact_fp32():
        load(ref, layer["fwd"], "")
        load(ref, layer["bwd"], "_reverse")
        port_ms = cuda_ms(torch, lambda: bilstm(x, [layer]), reps=5)
        # a contiguous [B, T, C] input takes another GEMM path
        port_contig_ms = cuda_ms(torch, lambda: bilstm(xc, [layer]), reps=5)
        lib_ms = cuda_ms(torch, lambda: ref(x), reps=5)
        err = float((ref(x)[0] - bilstm(x, [layer])).abs().max())
    log(f"bilstm layer T={T} B={B} H={H}: port_ms={port_ms:.4f} "
        f"(contiguous [B, T, C] input {port_contig_ms:.4f}) "
        f"library_ms(nn.LSTM bidirectional)={lib_ms:.4f} "
        f"library_vs_port_max_abs={err:.3e}")
    with torch.inference_mode():
        phase_profile(torch, lambda: bilstm(x, [layer]), port_ms,
                      "bilstm layer", top=6)
        phase_profile(torch, lambda: bilstm(xc, [layer]), port_contig_ms,
                      "bilstm layer, contiguous input", top=3)
    out["bilstm_layer"] = {"T": T, "B": B, "H": H, "port_ms": port_ms,
                           "port_contiguous_input_ms": port_contig_ms,
                           "library_ms": lib_ms, "library_vs_port": err}

    T, B, H = 6, 8, 512
    p = cuda_params(H, H)
    x = (torch.randn(B, T, H, generator=gen) * 0.5).to("cuda")
    h0 = c0 = torch.zeros(B, H, device="cuda")
    ref = torch.nn.LSTM(H, H, 1, batch_first=True).to("cuda")
    with torch.inference_mode(), exact_fp32():
        load(ref, p, "")
        gx = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b"]).contiguous()
        call_ms = cuda_ms(
            torch, lambda: lstm_recurrence(gx, p["w_hh"], h0, c0))
        layer_ms = cuda_ms(torch, lambda: _layer(x, p))
        lib_ms = cuda_ms(torch, lambda: ref(x))
        err = float((ref(x)[0] - _layer(x, p)[0]).abs().max())
    log(f"lstm stream chunk T={T} B={B} H={H}: kernel_call_ms={call_ms:.4f} "
        f"port_layer_ms={layer_ms:.4f} library_ms(nn.LSTM)={lib_ms:.4f} "
        f"library_vs_port_max_abs={err:.3e}")
    out["stream_chunk"] = {"T": T, "B": B, "H": H, "kernel_call_ms": call_ms,
                           "port_layer_ms": layer_ms, "library_ms": lib_ms,
                           "library_vs_port": err}

    # EnCodec-48k's LSTM layer over 88 windows of 150 frames, and its two
    # launch shapes (the wrapper runs 88 rows as 32 + 32 + 24)
    T, H = 150, 512
    p = cuda_params(H, H)
    ref = torch.nn.LSTM(H, H, 1, batch_first=True).to("cuda")
    out["chunked_48k"] = []
    with torch.inference_mode(), exact_fp32():
        load(ref, p, "")
        for B in (32, 24, 88):
            x = (torch.randn(B, T, H, generator=gen) * 0.5).to("cuda")
            h0 = c0 = torch.zeros(B, H, device="cuda")
            gx = (torch.matmul(x.transpose(0, 1), p["w_ih"])
                  + p["b"]).contiguous()
            call_ms = cuda_ms(
                torch, lambda: lstm_recurrence(gx, p["w_hh"], h0, c0))
            plain_ms = cuda_ms(torch, lambda: lstm_recurrence_reference(
                gx, p["w_hh"], h0, c0), reps=3)
            layer_ms = cuda_ms(torch, lambda: _layer(x, p))
            lib_ms = cuda_ms(torch, lambda: ref(x))
            err = float((ref(x)[0] - _layer(x, p)[0]).abs().max())
            log(f"lstm 48k layer T={T} B={B} H={H}: kernel_call_ms="
                f"{call_ms:.4f} plain_ms={plain_ms:.4f} port_layer_ms="
                f"{layer_ms:.4f} library_ms(nn.LSTM)={lib_ms:.4f} "
                f"library_vs_port_max_abs={err:.3e}")
            out["chunked_48k"].append(
                {"T": T, "B": B, "H": H, "kernel_call_ms": call_ms,
                 "plain_ms": plain_ms, "port_layer_ms": layer_ms,
                 "library_ms": lib_ms, "library_vs_port": err})

    # the downstream probes' layer (phase 40): the kernel call, its plain
    # version, the port's layer and nn.LSTM
    T, B, H = LSTM_PROBE
    p = cuda_params(H, H)
    ref = torch.nn.LSTM(H, H, 1, batch_first=True).to("cuda")
    x = (torch.randn(B, T, H, generator=gen) * 0.5).to("cuda")
    h0 = c0 = torch.zeros(B, H, device="cuda")
    with torch.inference_mode(), exact_fp32():
        load(ref, p, "")
        gx = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b"]).contiguous()
        call_ms = cuda_ms(torch, lambda: lstm_recurrence(gx, p["w_hh"], h0, c0))
        plain_ms = cuda_ms(torch, lambda: lstm_recurrence_reference(
            gx, p["w_hh"], h0, c0), reps=3)
        layer_ms = cuda_ms(torch, lambda: _layer(x, p))
        lib_ms = cuda_ms(torch, lambda: ref(x))
        err = float((ref(x)[0] - _layer(x, p)[0]).abs().max())
    log(f"lstm probe layer T={T} B={B} H={H}: kernel_call_ms={call_ms:.4f} "
        f"plain_ms={plain_ms:.4f} port_layer_ms={layer_ms:.4f} "
        f"library_ms(nn.LSTM)={lib_ms:.4f} library_vs_port_max_abs={err:.3e}")
    out["probe_h128"] = {"T": T, "B": B, "H": H, "kernel_call_ms": call_ms,
                         "plain_ms": plain_ms, "port_layer_ms": layer_ms,
                         "library_ms": lib_ms, "library_vs_port": err}
    return out


def _lstm_main_row(torch, gen, peaks, args, ms, ms1, name="lstm_recurrence"):
    """The kernel line's entry at a shape (the main path's, or the wide
    instance's): plain version, the port's layer, nn.LSTM and the bound."""
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.lstm import _layer
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence_reference)

    gx, w_hh, h0, c0 = args
    T, B, H4 = gx.shape
    H = H4 // 4
    s = 1.0 / math.sqrt(H)
    w_ih = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * s).to("cuda")
    b = ((torch.rand(4 * H, generator=gen) * 2 - 1) * s).to("cuda")
    with torch.inference_mode(), exact_fp32():
        plain_ms = cuda_ms(
            torch, lambda: lstm_recurrence_reference(gx, w_hh, h0, c0))
        x = (torch.randn(T, B, H, generator=gen) * 0.5).to("cuda")
        p = {"w_ih": w_ih, "w_hh": w_hh, "b": b}
        layer_ms = cuda_ms(torch, lambda: _layer(x.transpose(0, 1), p, h0, c0))
        ref = torch.nn.LSTM(H, H, 1).to("cuda")
        ref.weight_ih_l0.copy_(w_ih.T)
        ref.weight_hh_l0.copy_(w_hh.T)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
        lib_ms = cuda_ms(torch, lambda: ref(x, (h0[None], c0[None])))
        lib_err = float((ref(x, (h0[None], c0[None]))[0]
                         - _layer(x.transpose(0, 1), p, h0, c0)[0]
                         .transpose(0, 1)).abs().max())
    b_ms, b_by = _lstm_bound(T, B, H, peaks)
    log(f"{name} T={T} B={B} H={H}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} port_layer_ms={layer_ms:.4f} "
        f"library_ms(nn.LSTM)={lib_ms:.4f} library_vs_port_max_abs="
        f"{lib_err:.3e} bound_ms={b_ms:.4f} ({b_by})")
    return {"name": name, "status": "ported", "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "audiocodecs_tpu/ops/lstm_pallas.py:195",
            "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "port_layer_ms": layer_ms, "b1_ms": ms1,
            "shape": {"T": T, "B": B, "H": H}}


def _resblock_inputs(torch, gen, B, C, T, dev):
    Hc = C // 2

    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=gen) / math.sqrt(fan_in)).to(dev)

    x = (torch.randn(B, C, T, generator=gen) * 0.5).to(dev)
    weights = (w(Hc, C, 3, fan_in=3 * C), w(Hc, fan_in=3 * C),
               w(C, Hc, 1, fan_in=Hc), w(C, fan_in=Hc),
               w(C, C, 1, fan_in=C), w(C, fan_in=C))
    return x, weights


def phase_resblock(torch, peaks):
    from audiocodecs_tpu_torch.nn.layers import exact_fp32, pad1d
    from audiocodecs_tpu_torch.nn.seanet import (
        ResBlock, SEANetConfig, _resnet_plain)
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        pack_resblock_weights, seanet_resblock, seanet_resblock_info,
        seanet_resblock_reference)

    gen = torch.Generator().manual_seed(2)
    dev = "cuda"
    cfg = SEANetConfig()
    worst = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "cudnn_path_ms": 0.0, "flops": 0.0,
           "bytes": 0.0}
    per_shape = []
    for B, C, T in RESBLOCK_SHAPES + RESBLOCK_EXTRA:
        x, (w1, b1, w2, b2, ws, bs) = _resblock_inputs(torch, gen, B, C, T,
                                                       dev)
        with torch.inference_mode(), exact_fp32():
            halo = pad1d(x[..., :3], 2, 0, mode="reflect")[..., :2].contiguous()
            args = (x, halo, w1, b1, w2, b2, ws, bs)
            packed = pack_resblock_weights(w1, w2, ws)
            got = seanet_resblock(*args, packed=packed)
            want = seanet_resblock_reference(*args)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
        del got, want
        log(f"seanet_resblock B={B} C={C} T={T}: max_abs_err={err:.3e} "
            f"(limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            fail(f"seanet_resblock disagrees with its plain version: {err}")
        worst = max(worst, err)
        if (B, C, T) in RESBLOCK_EXTRA:
            continue
        blk = ResBlock(C, cfg).to(dev)
        with torch.inference_mode(), exact_fp32():
            for conv, (wt, bt) in zip((*blk.block, blk.shortcut),
                                      ((w1, b1), (w2, b2), (ws, bs))):
                conv.w.copy_(wt)
                conv.b.copy_(bt)
            ms = cuda_ms(torch, lambda: seanet_resblock(*args, packed=packed))
            plain_ms = cuda_ms(torch, lambda: seanet_resblock_reference(*args))
            cudnn_ms = cuda_ms(
                torch, lambda: _resnet_plain(x, blk, cfg, (1, 1)))
            pack_ms = cuda_ms(torch, lambda: pack_resblock_weights(w1, w2, ws))
        info = seanet_resblock_info(C, C // 2)
        Hc = C // 2
        flops = 2.0 * B * T * (3 * C * Hc + Hc * C + C * C)
        nbytes = 4.0 * (2 * B * C * T + 2 * B * C
                        + 3 * C * Hc + Hc * C + C * C + Hc + 2 * C)
        b_ms, b_by = bound(flops, nbytes, peaks)
        share = flops / peaks[0] / (ms / 1e3)
        log(f"seanet_resblock B={B} C={C} T={T}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} cudnn_path_ms={cudnn_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) fp32_share_of_peak={share:.3f} "
            f"pack_ms={pack_ms:.4f} {json.dumps(info)}")
        per_shape.append({"C": C, "T": T, "ms": ms, "plain_ms": plain_ms,
                          "cudnn_path_ms": cudnn_ms, "bound_ms": b_ms,
                          "fp32_share_of_peak": share, "pack_ms": pack_ms,
                          **info})
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["cudnn_path_ms"] += cudnn_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peaks)
    return {"name": "seanet_resblock", "status": "ported",
            "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "audiocodecs_tpu/ops/seanet_block_pallas.py:96",
            "launches": 0, "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "cudnn_path_ms": tot["cudnn_path_ms"],
            "per_shape": per_shape,
            "shape": "sum over the four main-path (C, T) shapes at B=8, "
                     "weights packed once"}


def phase_packed(torch, peaks):
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.seanet import (
        ResBlock, SEANetConfig, _resnet_plain)
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        seanet_resblock_packed, seanet_resblock_packed_reference)

    gen = torch.Generator().manual_seed(3)
    dev = "cuda"
    cfg = SEANetConfig(pad_mode="constant")
    worst = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "cudnn_path_ms": 0.0, "flops": 0.0,
           "bytes": 0.0}
    for B, C, T in PACKED_SHAPES + [PACKED_RAGGED]:
        x, (w1, b1, w2, b2, ws, bs) = _resblock_inputs(torch, gen, B, C, T,
                                                       dev)
        # the packed kernel's layouts: x [B, T, C], w1 [3, C, H], w2 [H, C]
        xt = x.transpose(1, 2).contiguous()
        args = (xt, w1.permute(2, 1, 0).contiguous(), b1,
                w2[..., 0].T.contiguous(), b2, ws[..., 0].T.contiguous(), bs)
        with torch.inference_mode(), exact_fp32():
            got = seanet_resblock_packed(*args)
            want = seanet_resblock_packed_reference(*args)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
        log(f"seanet_resblock_packed B={B} C={C} T={T}: max_abs_err={err:.3e}"
            f" (limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            fail(f"seanet_resblock_packed disagrees with its plain version: "
                 f"{err}")
        worst = max(worst, err)
        if (B, C, T) == PACKED_RAGGED:
            continue
        blk = ResBlock(C, cfg).to(dev)
        with torch.inference_mode(), exact_fp32():
            for conv, (wt, bt) in zip((*blk.block, blk.shortcut),
                                      ((w1, b1), (w2, b2), (ws, bs))):
                conv.w.copy_(wt)
                conv.b.copy_(bt)
            ms = cuda_ms(torch, lambda: seanet_resblock_packed(*args))
            plain_ms = cuda_ms(
                torch, lambda: seanet_resblock_packed_reference(*args))
            cudnn_ms = cuda_ms(torch, lambda: _resnet_plain(
                xt.transpose(1, 2), blk, cfg, (1, 1)).transpose(1, 2))
        Hc = C // 2
        flops = 2.0 * B * T * (3 * C * Hc + Hc * C + C * C)
        nbytes = 4.0 * (2 * B * C * T + 3 * C * Hc + Hc * C + C * C + Hc
                        + 2 * C)
        b_ms, b_by = bound(flops, nbytes, peaks)
        log(f"seanet_resblock_packed B={B} C={C} T={T}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} cudnn_path_ms={cudnn_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"fp32_share_of_peak={flops / peaks[0] / (ms / 1e3):.3f}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["cudnn_path_ms"] += cudnn_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peaks)
    return {"name": "seanet_resblock_packed", "status": "ported",
            "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "audiocodecs_tpu/ops/seanet_block_packed.py:123",
            "launches": 0, "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "cudnn_path_ms": tot["cudnn_path_ms"],
            "shape": "sum over (C, T) = (32, 240000), (64, 120000) at B=8; "
                     "no model calls it"}


def _unit_inputs(torch, gen, B, C, T, dev):
    def n(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = n(B, C, T, scale=0.5)
    weights = (n(C, C, 7, scale=1 / math.sqrt(7 * C)), n(C, scale=0.1),
               (torch.randn(C, generator=gen).abs() + 0.5).to(dev),
               n(C, C, 1, scale=1 / math.sqrt(C)), n(C, scale=0.1),
               (torch.randn(C, generator=gen).abs() + 0.5).to(dev))
    return x, weights


def phase_dac_resunit(torch, peaks):
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit, dac_resunit_info, dac_resunit_reference,
        pack_resunit_weights)

    gen = torch.Generator().manual_seed(4)
    dev = "cuda"
    worst = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    per_shape = []
    for B, C, T, d in DAC_UNIT_SHAPES + DAC_UNIT_EXTRA:
        x, weights = _unit_inputs(torch, gen, B, C, T, dev)
        with torch.inference_mode():
            packed = pack_resunit_weights(weights[0], weights[3])
            got = dac_resunit(x, *weights, d, packed=packed)
            want = dac_resunit_reference(x, *weights, d)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
        del got, want
        log(f"dac_resunit B={B} C={C} T={T} d={d}: max_abs_err={err:.3e} "
            f"(limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            fail(f"dac_resunit disagrees with its plain version: {err}")
        worst = max(worst, err)
        if (B, C, T, d) in DAC_UNIT_EXTRA:
            continue
        with torch.inference_mode():
            ms = cuda_ms(torch,
                         lambda: dac_resunit(x, *weights, d, packed=packed))
            plain_ms = cuda_ms(
                torch, lambda: dac_resunit_reference(x, *weights, d))
            pack_ms = cuda_ms(
                torch, lambda: pack_resunit_weights(weights[0], weights[3]))
        occ = dac_resunit_info(C, d)
        flops = 2.0 * B * T * 8 * C * C
        nbytes = 4.0 * (2 * B * C * T + 8 * C * C + 4 * C)
        b_ms, b_by = bound(flops, nbytes, peaks)
        share = flops / peaks[0] / (ms / 1e3)
        log(f"dac_resunit B={B} C={C} T={T} d={d}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} kernel/plain={ms / plain_ms:.3f} "
            f"bound_ms={b_ms:.4f} ({b_by}) fp32_share_of_peak={share:.3f} "
            f"pack_ms={pack_ms:.4f} regs={occ['regs']} "
            f"smem_bytes={occ['smem_bytes']} "
            f"blocks_per_sm={occ['blocks_per_sm']}")
        per_shape.append({"C": C, "T": T, "d": d, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "fp32_share_of_peak": share, "pack_ms": pack_ms,
                          **occ})
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    budget = {f"C={C} d={d}": tuple(dac_resunit_info(C, d).values())
              for C in (48, 96, 192, 256) for d in (1, 3, 9)}
    log(f"dac_resunit (regs, smem_bytes, blocks_per_sm): {budget}")
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peaks)
    big = _dac_unit_model(torch, gen, peaks, "BigCodec", DAC_UNIT_BIGCODEC)
    bi = _dac_unit_model(torch, gen, peaks, "BiCodec", DAC_UNIT_BICODEC)
    worst = max(worst, big["max_abs_err"], bi["max_abs_err"])
    return {"name": "dac_resunit", "status": "ported", "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/dac_resunit.cu",
            "replaces": "audiocodecs_tpu/ops/dac_resunit_pallas.py:114",
            "launches": 0, "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "per_shape": per_shape, "bigcodec": big,
            "bicodec": bi,
            "shape": "sum over the six fused units of one B=1 x 10 s decode,"
                     " weights packed once"}


def _dac_unit_model(torch, gen, peaks, model, shapes) -> dict:
    """B4 at a model's fused decoder units (``shapes``: BigCodec-16k's nine
    or BiCodec-16k's six for B = 8 x 10 s): each held against its plain
    version (limit 1e-5 · max(1, max|out|)), then the kernel on weights
    packed once beside the plain version, which is the model's cuDNN path
    (snake, ``F.conv1d`` with TF32 off), and the bound."""
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit, dac_resunit_reference, pack_resunit_weights)

    tot = {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    worst, per_shape = 0.0, []
    for B, C, T, d in shapes:
        x, weights = _unit_inputs(torch, gen, B, C, T, "cuda")
        with torch.inference_mode():
            packed = pack_resunit_weights(weights[0], weights[3])
            got = dac_resunit(x, *weights, d, packed=packed)
            want = dac_resunit_reference(x, *weights, d)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            del got, want
            if not err <= 1e-5 * scale:
                fail(f"dac_resunit disagrees with its plain version at "
                     f"{model}'s B={B} C={C} T={T} d={d}: {err}")
            ms = cuda_ms(torch,
                         lambda: dac_resunit(x, *weights, d, packed=packed),
                         reps=5)
            plain_ms = cuda_ms(
                torch, lambda: dac_resunit_reference(x, *weights, d), reps=5)
        flops = 2.0 * B * T * 8 * C * C
        nbytes = 4.0 * (2 * B * C * T + 8 * C * C + 4 * C)
        b_ms, b_by = bound(flops, nbytes, peaks)
        log(f"dac_resunit {model} B={B} C={C} T={T} d={d}: max_abs_err="
            f"{err:.3e} (limit {1e-5 * scale:.3e}) kernel_ms={ms:.4f} "
            f"plain_ms(cuDNN path)={plain_ms:.4f} kernel/plain="
            f"{ms / plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) "
            f"fp32_share_of_peak={flops / peaks[0] / (ms / 1e3):.3f}")
        per_shape.append({"B": B, "C": C, "T": T, "d": d, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "max_abs_err": err})
        worst = max(worst, err)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("flops", flops),
                     ("bytes", nbytes)):
            tot[k] += v
        del x, weights, packed
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peaks)
    log(f"dac_resunit {model}, the {len(shapes)} units of a B=8 x 10 s "
        f"decode: kernel_ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    return {"ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst, "per_shape": per_shape}


def _form_unit(torch, C, d, form, weights, dtype):
    """The model's unfused residual unit in a form (the path the decoders'
    wide units take), holding ``weights``: the form's library yardstick."""
    from audiocodecs_tpu_torch.models.dac import DecodeForm, ResidualUnit

    precision, poly, _ = _NEW_FORMS[form]
    unit = ResidualUnit(C, d, fused=False,
                        form=DecodeForm(dtype, precision, poly)).cuda()
    with torch.no_grad():
        for dst, src in zip((unit.conv1.w, unit.conv1.b, unit.alpha1,
                             unit.conv2.w, unit.conv2.b, unit.alpha2),
                            weights):
            dst.copy_(src.float())
    return unit


def _dac_unit_form(torch, form, shapes, peaks, gen, label):
    """One form of B4 at ``shapes`` (B, C, T, d): the kernel against its
    plain version (exact form: within 1e-5 · max(1, max|plain|); default
    form: ``default_errors``, one rounding point at a time), then the
    kernel on weights packed once, the plain version and the model's
    unfused unit in the same form and dtype (library), each timed, and the
    bound (one bf16 pass at 989 TFLOP/s, or fp32 at the fp32 peak; bytes
    at the HBM rate)."""
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit, dac_resunit_info, dac_resunit_reference,
        dac_resunit_stages, default_errors, pack_resunit_weights)

    precision, poly, dt = _NEW_FORMS[form]
    dtype = getattr(torch, dt)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
           "bytes": 0.0}
    worst, per_shape = 0.0, []
    for B, C, T, d in shapes:
        x, weights = _unit_inputs(torch, gen, B, C, T, "cuda")
        x, weights = x.to(dtype), [w.to(dtype) for w in weights]
        kw = dict(precision=precision, snake_poly=poly)
        unit = _form_unit(torch, C, d, form, weights, dtype)
        with torch.inference_mode():
            packed = pack_resunit_weights(weights[0], weights[3], precision)
            got = dac_resunit(x, *weights, d, packed=packed, **kw)
            want = dac_resunit_reference(x, *weights, d, **kw)
            err = float((got.float() - want.float()).abs().max())
            if precision == "exact":
                torch.cuda.synchronize()
                lim = 1e-5 * max(1.0, float(want.abs().max()))
                check = {"limit": lim}
                ok = err <= lim
            else:
                out, h2 = dac_resunit_stages(x, *weights, d, snake_poly=poly,
                                             packed=packed)
                check = default_errors(out, h2, x, *weights, d, poly)
                ok = check["ok"] and torch.equal(out, got)
                del out, h2
            del got, want
            if not ok:
                fail(f"dac_resunit {form} disagrees with its plain version "
                     f"at B={B} C={C} T={T} d={d}: {err} {check}")
            ms = cuda_ms(torch, lambda: dac_resunit(
                x, *weights, d, packed=packed, **kw), reps=5)
            plain_ms = cuda_ms(torch, lambda: dac_resunit_reference(
                x, *weights, d, **kw), reps=5)
            lib_ms = cuda_ms(torch, lambda: unit(x), reps=5)
        flops = 2.0 * B * T * 8 * C * C
        if precision == "default":
            nbytes = (2 * B * C * T * x.element_size() + 2 * 8 * C * C
                      + 4 * C * x.element_size())
            b_ms, b_by = bound(flops, nbytes, (BF16_PEAK, peaks[1]))
        else:
            nbytes = 4.0 * (2 * B * C * T + 8 * C * C + 4 * C)
            b_ms, b_by = bound(flops, nbytes, peaks)
        occ = dac_resunit_info(C, d, precision, poly, dtype)
        log(f"dac_resunit {form} {label} B={B} C={C} T={T} d={d}: "
            f"max_abs_err={err:.3e} check={json.dumps(check)} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(unfused unit)={lib_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) kernel/bound={ms / b_ms:.2f} regs={occ['regs']} "
            f"local_bytes={occ['local_bytes']} "
            f"smem_bytes={occ['smem_bytes']} "
            f"blocks_per_sm={occ['blocks_per_sm']}")
        per_shape.append({"B": B, "C": C, "T": T, "d": d, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": b_ms, "max_abs_err": err, **occ,
                          **{k: v for k, v in check.items() if k != "ok"}})
        worst = max(worst, err)
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("flops", flops),
                     ("bytes", nbytes)):
            tot[k] += v
        del x, weights, packed, unit
    peak = BF16_PEAK if precision == "default" else peaks[0]
    b_ms, b_by = bound(tot["flops"], tot["bytes"], (peak, peaks[1]))
    log(f"dac_resunit {form} {label}, {len(shapes)} units: kernel_ms="
        f"{tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} library_ms="
        f"{tot['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")
    return {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst, "per_shape": per_shape}


def phase_dac_resunit_forms(torch, peaks):
    """B4's other forms (exact with the polynomial snake; one bf16 pass
    with the sin or the polynomial snake, on fp32 or bf16 activations) at
    the DAC-44.1k decoder's six units (B = 1 x 10 s) and BigCodec-16k's
    nine (B = 8 x 10 s): one kernel row each."""
    gen = torch.Generator().manual_seed(5)
    rows = []
    for form in _NEW_FORMS:
        dac = _dac_unit_form(torch, form, DAC_UNIT_SHAPES, peaks, gen,
                             "DAC")
        big = _dac_unit_form(torch, form, DAC_UNIT_BIGCODEC, peaks, gen,
                             "BigCodec")
        rows.append({
            "name": f"dac_resunit_{form}", "status": "ported",
            "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/dac_resunit.cu",
            "replaces": "audiocodecs_tpu/ops/dac_resunit_pallas.py:114",
            "launches": 0,
            "max_abs_err": max(dac["max_abs_err"], big["max_abs_err"]),
            "ms": dac["ms"], "plain_ms": dac["plain_ms"],
            "bound_ms": dac["bound_ms"], "bound_by": dac["bound_by"],
            "library_ms": dac["library_ms"], "bigcodec": big,
            "per_shape": dac["per_shape"],
            "shape": "sum over the six fused units of one DAC-44.1k B=1 x "
                     "10 s decode, weights packed once; library: the "
                     "model's unfused unit in the same form"})
    return rows


def _counters():
    from audiocodecs_tpu_torch.ops.dac_resunit import dac_resunit
    from audiocodecs_tpu_torch.ops.lstm_recurrence import lstm_recurrence
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        seanet_resblock, seanet_resblock_packed)

    return {f.__name__: f for f in (lstm_recurrence, seanet_resblock,
                                    seanet_resblock_packed, dac_resunit)}


def reset_counts() -> None:
    for name, f in _counters().items():
        if name != "dac_resunit":
            f.launches = 0
        if name.startswith("seanet_resblock"):
            for form in f.launches_by_form:
                f.launches_by_form[form] = 0
    _counters()["lstm_recurrence"].wide_launches = 0
    _counters()["lstm_recurrence"].launches_by_hidden.clear()
    by_form = _counters()["dac_resunit"].launches_by_form
    for form in by_form:
        by_form[form] = 0


def read_counts() -> dict:
    """Launches by wrapper since ``reset_counts``; ``lstm_recurrence_wide``
    counts the LSTM launches of the wide instance (H > 1024) among
    ``lstm_recurrence``'s; ``dac_resunit`` counts the DAC unit's exact sin
    form and ``dac_resunit_<form>`` each of its other forms;
    ``seanet_resblock`` (and ``_packed``) the SEANet block's exact form and
    ``seanet_resblock[_packed]_default_{f32,bf16}`` its one-pass form."""
    counts = {name: f.launches for name, f in _counters().items()
              if name != "dac_resunit"}
    counts["lstm_recurrence_wide"] = _counters()[
        "lstm_recurrence"].wide_launches
    by_form = _counters()["dac_resunit"].launches_by_form
    counts["dac_resunit"] = by_form["exact"]
    for form in _NEW_FORMS:
        counts[f"dac_resunit_{form}"] = by_form[form]
    for name in ("seanet_resblock", "seanet_resblock_packed"):
        for form, n in _counters()[name].launches_by_form.items():
            counts[f"{name}_{form}"] = n
    return counts


def lstm_launches_by_hidden() -> dict:
    """The LSTM kernel's launches since ``reset_counts`` by width:
    ``{H: launches}``."""
    return dict(_counters()["lstm_recurrence"].launches_by_hidden)


def _server_pair(torch, cls, *args, **kwargs):
    """The codec on the card with seeded random weights, and the same
    weights on the CPU."""
    codec = cls(*args, device="cuda",
                generator=torch.Generator().manual_seed(0), **kwargs)
    state = {k: v.detach().cpu() for k, v in codec.state_dict().items()}
    return codec, cls(*args, device="cpu", state_dict=state, **kwargs)


def _noise(rng, shapes):
    return [rng.standard_normal(shape).astype(np.float32) * 0.1
            for shape in shapes]


def _hop_shapes(hop: int, K: int, frames=math.ceil):
    """shapes(sig_shape) → (toks, sig) of a codec of ``K`` codebooks that
    makes ``frames(T / hop)`` token frames of a T-sample request and
    decodes ``hop`` samples a frame."""
    def shapes(shape):
        N = frames(shape[1] / hop)
        return (shape[0], N, K), (shape[0], N * hop)
    return shapes


def _launch_table(lstm, resblock, dac=0, wide=0, **forms):
    """The launches of a run: ``dac`` of the DAC unit's exact sin form,
    ``forms`` (name → count) of its other forms and of the SEANet block's
    one-pass form (``B2_FORMS``)."""
    table = {"lstm_recurrence": lstm, "seanet_resblock": resblock,
             "seanet_resblock_packed": 0, "dac_resunit": dac,
             "lstm_recurrence_wide": wide}
    for form in _NEW_FORMS:
        table[f"dac_resunit_{form}"] = forms.pop(form, 0)
    for name in B2_FORMS:
        table[name] = forms.pop(name, 0)
    if forms:
        raise ValueError(f"unknown forms {sorted(forms)}")
    return table


def phase_main_path(torch, rows):
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        pack_resblock_weights)
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, B, seconds = 24000, 8, 10.0
    T = int(sr * seconds)
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=8)
    requests = _noise(np.random.default_rng(0), [(B, T), (B, T), (1, 79201)])

    # the counted run: the EnCodec path only
    reset_counts()
    answers, packs = [], []
    for sig in requests:
        p0 = pack_resblock_weights.packs
        toks = codec.sig_to_toks(sig)
        answers.append((toks, codec.toks_to_sig(toks)))
        packs.append(pack_resblock_weights.packs - p0)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"EnCodec path launches over {len(requests)} roundtrips: "
        f"{json.dumps(counts)}; seanet_resblock weight packs per roundtrip: "
        f"{packs}")
    n = len(requests)
    want = _launch_table(4 * n, 8 * n)
    if counts != want:
        fail(f"expected launches {want}, got {counts}")
    if packs != [8] + [0] * (n - 1):
        fail(f"expected the fused blocks to pack once, got {packs}")
    _add_launches(rows, "encodec_24k", counts)

    for sig, (toks, y) in zip(requests, answers):
        N = math.ceil(sig.shape[1] / 320)
        if tuple(toks.shape) != (sig.shape[0], N, 8) or tuple(y.shape) != (
                sig.shape[0], N * 320):
            fail(f"shapes: toks {tuple(toks.shape)}, sig {tuple(y.shape)} "
                 f"for input {sig.shape}")
        if not bool(torch.isfinite(y).all()):
            fail("non-finite waveform")
    if tuple(answers[0][0].shape) != (8, 750, 8):
        fail(f"main request tokens {tuple(answers[0][0].shape)}")

    # parity against the plain versions on the CPU, same weights
    for i in (0, 2):
        sig, (toks, y) = requests[i], answers[i]
        f_gpu = codec.sig_to_feats(sig).cpu()
        f_cpu = cpu.sig_to_feats(sig)
        f_err = float((f_gpu - f_cpu).abs().max())
        f_lim = 1e-4 * float(f_cpu.abs().max())
        t_cpu = cpu.sig_to_toks(sig)
        mism = int((toks.cpu() != t_cpu).sum())
        match = 1.0 - mism / t_cpu.numel()
        y_cpu = cpu.toks_to_sig(toks.cpu())
        y_err = float((y.cpu() - y_cpu).abs().max())
        y_lim = 1e-4 * float(y_cpu.abs().max())
        log(f"request {i} {sig.shape}: feats max_abs_diff={f_err:.3e} "
            f"(limit {f_lim:.3e}); token_match={match:.6f} "
            f"({mism} of {t_cpu.numel()} differ); decode max_abs_diff="
            f"{y_err:.3e} (limit {y_lim:.3e})")
        if not f_err <= f_lim:
            fail("features disagree with the CPU path")
        if not match >= 0.999:
            fail(f"token_match {match} < 0.999")
        if not y_err <= y_lim:
            fail("decoded waveform disagrees with the CPU path")

    # warm roundtrip time, stages, peak memory
    sig = requests[0]
    sig_dev = torch.as_tensor(sig, device="cuda")
    rt_ms = cuda_ms(torch, lambda: codec.roundtrip(sig_dev), reps=5)
    with torch.inference_mode():
        feats = codec._sig_to_feats(sig_dev, None)
        toks = rvq_encode(feats, codec.codebooks, 8)
        q = rvq_decode(toks, codec.codebooks)
        stages = {
            "encoder_ms": cuda_ms(
                torch, lambda: codec._sig_to_feats(sig_dev, None), reps=5),
            "rvq_encode_ms": cuda_ms(
                torch, lambda: rvq_encode(feats, codec.codebooks, 8), reps=5),
            "rvq_decode_ms": cuda_ms(
                torch, lambda: rvq_decode(toks, codec.codebooks), reps=5),
            "decoder_ms": cuda_ms(
                torch, lambda: codec._feats_to_sig(q, None), reps=5),
        }
    torch.cuda.reset_peak_memory_stats()
    codec.roundtrip(sig_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_stream = seconds / (rt_ms / 1e3)
    log(f"roundtrip B={B} x {seconds} s: {rt_ms:.3f} ms warm; "
        f"rtf_per_stream={per_stream:.3f} rtf_aggregate={per_stream * B:.3f};"
        f" peak_mem_bytes={peak}")
    log(f"stages: {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    phase_profile(torch, lambda: codec.roundtrip(sig_dev), rt_ms)


def phase_dac_path(torch, rows):
    from audiocodecs_tpu_torch.models.dac import (
        DAC, dac_rvq_decode, dac_rvq_encode)
    from audiocodecs_tpu_torch.ops.dac_resunit import pack_resunit_weights

    sr, K, seconds = 44100, 9, 10.0
    codec, cpu = _server_pair(torch, DAC, sr, sr, num_codebooks=K)
    T = int(sr * seconds)
    requests = _noise(np.random.default_rng(1), [(1, T), (1, T), (2, 100001)])
    want_shapes = [((1, 861, K), (1, 440832)), ((1, 861, K), (1, 440832)),
                   ((2, 195, K), (2, 99840))]

    # the counted run: the DAC path only
    reset_counts()
    answers, per_call, packs = [], [], []
    for sig in requests:
        before = read_counts()["dac_resunit"]
        toks = codec.sig_to_toks(sig)
        mid = read_counts()["dac_resunit"]
        p0 = pack_resunit_weights.packs
        y = codec.toks_to_sig(toks)
        per_call.append((mid - before, read_counts()["dac_resunit"] - mid))
        packs.append(pack_resunit_weights.packs - p0)
        answers.append((toks, y))
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"DAC path launches over {len(requests)} roundtrips: "
        f"{json.dumps(counts)}; dac_resunit (sig_to_toks, toks_to_sig) per "
        f"request: {per_call}; weight packs per toks_to_sig: {packs}")
    n = len(requests)
    want = _launch_table(0, 0, dac=6 * n)
    if counts != want or any(c != (0, 6) for c in per_call):
        fail(f"expected launches {want} and (0, 6) per request, got "
             f"{counts}, {per_call}")
    if packs != [6] + [0] * (n - 1):
        fail(f"expected the fused units to pack once, got {packs}")
    _add_launches(rows, "dac_44k", counts)

    for sig, (toks, y), (ts, ys) in zip(requests, answers, want_shapes):
        if tuple(toks.shape) != ts or tuple(y.shape) != ys:
            fail(f"shapes: toks {tuple(toks.shape)}, sig {tuple(y.shape)} "
                 f"for input {sig.shape}; want {ts}, {ys}")
        if not bool(torch.isfinite(y).all()):
            fail("non-finite waveform")

    # parity against the plain versions on the CPU, same weights: the
    # ragged request, then one 10 s request (3 s if the CPU would take over
    # 120 s for it)
    def parity(label, sig, toks, y):
        t0 = time.perf_counter()
        f_gpu = codec.sig_to_feats(sig).cpu()
        f_cpu = cpu.sig_to_feats(sig)
        with torch.inference_mode():
            t_cpu = dac_rvq_encode(f_cpu, cpu.quantizer, K)
        y_cpu = cpu.toks_to_sig(toks.cpu())
        cpu_s = time.perf_counter() - t0
        f_err = float((f_gpu - f_cpu).abs().max())
        f_lim = 1e-4 * float(f_cpu.abs().max())
        mism = int((toks.cpu() != t_cpu).sum())
        match = 1.0 - mism / t_cpu.numel()
        y_err = float((y.cpu() - y_cpu).abs().max())
        y_lim = 1e-4 * float(y_cpu.abs().max())
        log(f"DAC {label} {sig.shape}: feats max_abs_diff={f_err:.3e} "
            f"(limit {f_lim:.3e}); token_match={match:.6f} ({mism} of "
            f"{t_cpu.numel()} differ); decode max_abs_diff={y_err:.3e} "
            f"(limit {y_lim:.3e}); cpu_seconds={cpu_s:.1f}")
        if not f_err <= f_lim:
            fail("DAC features disagree with the CPU path")
        if not match >= 0.999:
            fail(f"DAC token_match {match} < 0.999")
        if not y_err <= y_lim:
            fail("DAC decoded waveform disagrees with the CPU path")
        return cpu_s

    cpu_s = parity("request 2", requests[2], *answers[2])
    est = cpu_s * T / requests[2].size
    if est <= 120.0:
        parity("request 0", requests[0], *answers[0])
    else:
        short = np.ascontiguousarray(requests[0][:, : 3 * sr])
        log(f"DAC 10 s parity would take ~{est:.0f} s on the CPU: checking "
            f"the first 3 s of request 0 instead")
        toks = codec.sig_to_toks(short)
        parity("request 0, first 3 s", short, toks, codec.toks_to_sig(toks))

    # warm roundtrip time, stages, peak memory
    sig_dev = torch.as_tensor(requests[0], device="cuda")
    rt_ms = cuda_ms(torch, lambda: codec.roundtrip(sig_dev), reps=5)
    with torch.inference_mode():
        feats = codec._encode_feats(sig_dev, None)
        toks = dac_rvq_encode(feats, codec.quantizer, K)
        q = dac_rvq_decode(toks, codec.quantizer)
        stages = {
            "encoder_ms": cuda_ms(
                torch, lambda: codec._encode_feats(sig_dev, None), reps=5),
            "rvq_encode_ms": cuda_ms(
                torch, lambda: dac_rvq_encode(feats, codec.quantizer, K),
                reps=5),
            "rvq_decode_ms": cuda_ms(
                torch, lambda: dac_rvq_decode(toks, codec.quantizer), reps=5),
            "decoder_ms": cuda_ms(
                torch, lambda: codec._feats_to_sig(q, None), reps=5),
        }
    torch.cuda.reset_peak_memory_stats()
    codec.roundtrip(sig_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"DAC roundtrip B=1 x {seconds} s: {rt_ms:.3f} ms warm; "
        f"rtf_per_stream={seconds / (rt_ms / 1e3):.3f}; "
        f"peak_mem_bytes={peak}")
    log(f"DAC stages: "
        f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    phase_profile(torch, lambda: codec.roundtrip(sig_dev), rt_ms)


def _add_launches(rows, path: str, counts: dict) -> None:
    for row in rows:
        row.setdefault("launches_by_path", {})[path] = counts[row["name"]]
        row["launches"] += counts[row["name"]]


def _parity(label, codec, cpu, sig, toks, y, n_rows=None):
    """The card's features, tokens and decode of ``sig`` (its first
    ``n_rows`` rows) against the CPU path on the same weights: features
    within 1e-4 · max|feats|, token_match ≥ 0.999, the decode of the same
    tokens within 1e-4 · max|sig|."""
    rows = slice(0, n_rows)
    t0 = time.perf_counter()
    f_gpu = codec.sig_to_feats(sig)[rows].cpu()
    sig = np.ascontiguousarray(sig[rows])
    f_cpu = cpu.sig_to_feats(sig)
    t_cpu = cpu.sig_to_toks(sig)
    toks, y = toks[rows].cpu(), y[rows].cpu()
    y_cpu = cpu.toks_to_sig(toks)
    cpu_s = time.perf_counter() - t0
    f_err = float((f_gpu - f_cpu).abs().max())
    f_lim = 1e-4 * float(f_cpu.abs().max())
    mism = int((toks != t_cpu).sum())
    match = 1.0 - mism / t_cpu.numel()
    y_err = float((y - y_cpu).abs().max())
    y_lim = 1e-4 * float(y_cpu.abs().max())
    log(f"{label} {sig.shape}: feats max_abs_diff={f_err:.3e} (limit "
        f"{f_lim:.3e}); token_match={match:.6f} ({mism} of {t_cpu.numel()} "
        f"differ); decode max_abs_diff={y_err:.3e} (limit {y_lim:.3e}); "
        f"cpu_seconds={cpu_s:.1f}")
    if not f_err <= f_lim:
        fail(f"{label}: features disagree with the CPU path")
    if not match >= 0.999:
        fail(f"{label}: token_match {match} < 0.999")
    if not y_err <= y_lim:
        fail(f"{label}: decoded waveform disagrees with the CPU path")


def _batch_path(torch, rows, path, codec, cpu, requests, per_roundtrip,
                shapes, quant, parity_rows=2, profile_decode=None,
                packs=None):
    """A codec as a small server: the requests through ``sig_to_toks`` →
    ``toks_to_sig`` with every kernel's launches counted (``per_roundtrip``
    each, or ``per_roundtrip(sig_shape)`` where it depends on the request),
    the shapes (``shapes(sig_shape)`` → (toks, sig)) and finite output
    checked, parity against the CPU path on the last request and on the
    first ``parity_rows`` rows of the first (none if ``None``), then the warm
    roundtrip of the first request timed: ms, RTF per stream and in
    aggregate, peak memory, stages (``quant`` = (tokens of features,
    features of tokens, waveform of features), or ``None``) and the device
    time by kernel, also of the decode from features alone when
    ``profile_decode`` names it. ``packs`` = (a counter of weight packs, the
    packs of the first decode): the fused weights are packed on the first
    decode only. Returns the warm roundtrip's ms."""
    reset_counts()
    answers, packed = [], []
    for sig in requests:
        toks = codec.sig_to_toks(sig)
        p0 = packs[0]() if packs else 0
        answers.append((toks, codec.toks_to_sig(toks)))
        packed.append(packs[0]() - p0 if packs else 0)
    torch.cuda.synchronize()
    counts = read_counts()
    n = len(requests)
    log(f"{path} launches over {n} roundtrips: {json.dumps(counts)}"
        + (f"; weight packs per toks_to_sig: {packed}" if packs else ""))
    if packs and packed != [packs[1]] + [0] * (n - 1):
        fail(f"{path}: expected the fused weights to pack on the first "
             f"decode only, got {packed}")
    each = [per_roundtrip(sig.shape) if callable(per_roundtrip)
            else per_roundtrip for sig in requests]
    want = {k: sum(e[k] for e in each) for k in each[0]}
    if counts != want:
        fail(f"{path}: expected launches {want}, got {counts}")
    _add_launches(rows, path, counts)
    for sig, (toks, y) in zip(requests, answers):
        ts, ys = shapes(sig.shape)
        if tuple(toks.shape) != ts or tuple(y.shape) != ys:
            fail(f"{path} shapes: toks {tuple(toks.shape)}, sig "
                 f"{tuple(y.shape)} for input {sig.shape}; want {ts}, {ys}")
        if not bool(torch.isfinite(y).all()):
            fail(f"{path}: non-finite waveform")
    _parity(f"{path} request {n - 1}", codec, cpu, requests[-1],
            *answers[-1])
    if parity_rows is not None:
        _parity(f"{path} request 0, rows 0-{parity_rows - 1}", codec, cpu,
                requests[0], *answers[0], n_rows=parity_rows)

    sig = requests[0]
    B, seconds = sig.shape[0], sig.shape[1] / codec.sample_rate
    sig_dev = torch.as_tensor(sig, device="cuda")
    rt_ms = cuda_ms(torch, lambda: codec.roundtrip(sig_dev), reps=5)
    if quant is not None:
        to_toks, to_q, to_sig = quant
        with torch.inference_mode():
            feats = codec._sig_to_feats(sig_dev, None)
            toks = to_toks(feats)
            q = to_q(toks)
            stages = {
                "encoder_ms": cuda_ms(
                    torch, lambda: codec._sig_to_feats(sig_dev, None),
                    reps=5),
                "rvq_encode_ms": cuda_ms(torch, lambda: to_toks(feats),
                                         reps=5),
                "rvq_decode_ms": cuda_ms(torch, lambda: to_q(toks), reps=5),
                "decoder_ms": cuda_ms(torch, lambda: to_sig(q), reps=5),
            }
    torch.cuda.reset_peak_memory_stats()
    codec.roundtrip(sig_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_stream = seconds / (rt_ms / 1e3)
    log(f"{path} roundtrip B={B} x {seconds} s: {rt_ms:.3f} ms warm; "
        f"rtf_per_stream={per_stream:.3f} rtf_aggregate={per_stream * B:.3f};"
        f" peak_mem_bytes={peak}")
    if quant is not None:
        log(f"{path} stages: "
            f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    phase_profile(torch, lambda: codec.roundtrip(sig_dev), rt_ms)
    if profile_decode is not None:
        with torch.inference_mode():
            phase_profile(torch, lambda: to_sig(q), stages["decoder_ms"],
                          profile_decode)
    return rt_ms


def phase_speechtokenizer(torch, rows):
    from audiocodecs_tpu_torch.models.speechtokenizer import SpeechTokenizer
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop = 16000, 8, 320
    codec, cpu = _server_pair(torch, SpeechTokenizer, sr, sr, num_codebooks=K)
    requests = _noise(np.random.default_rng(5),
                      [(8, 10 * sr), (8, 10 * sr), (1, 80001)])

    # 2 encoder BiLSTM layers x 2 directions + 2 decoder LSTM layers
    _batch_path(torch, rows, "speechtokenizer_16k", codec, cpu, requests,
                _launch_table(6, 0), _hop_shapes(hop, K),
                (lambda f: rvq_encode(f, codec.codebooks, K),
                 lambda t: rvq_decode(t, codec.codebooks),
                 lambda q: codec._feats_to_sig(q, None)))


def _stream(torch, codec, sig, frames: int, toks_in=None):
    """``sig`` [B, T] through ``encode_chunk`` then ``decode_chunk`` in
    chunks of ``frames`` token frames (the decoder takes ``toks_in``'s
    chunk if given, else the encoder's), synced after each chunk on the
    card → (tokens, waveform, ms a chunk by the host's clock)."""
    step = codec.frame_size * frames
    enc = codec.init_streaming_state(sig.shape[0])
    dec = codec.init_streaming_state(sig.shape[0])
    on_card = codec.device.type == "cuda"
    toks, wav, ms = [], [], []
    for i, pos in enumerate(range(0, sig.shape[1], step)):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        t, enc = codec.encode_chunk(sig[:, pos:pos + step], enc)
        w, dec = codec.decode_chunk(
            t if toks_in is None else toks_in[:, i * frames:(i + 1) * frames],
            dec)
        if on_card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(t)
        wav.append(w)
    return torch.cat(toks, 1), torch.cat(wav, 1), ms


def _stream_times(torch, path, codec, sig_dev, frames, seconds):
    """A second, warm pass of the stream: median and p90 ms a chunk
    (encode + decode, synced each chunk) and the RTF a stream; then the
    device time by kernel over the first 10 chunks of a third pass."""
    _, _, ms = _stream(torch, codec, sig_dev, frames)
    srt = sorted(ms)
    p90 = srt[min(len(srt) - 1, math.ceil(0.9 * len(srt)) - 1)]
    chunk_s = codec.frame_size * frames / codec.sample_rate
    log(f"{path} stream B={sig_dev.shape[0]} x {seconds} s in {len(ms)} "
        f"chunks of {chunk_s * 1e3:.0f} ms: chunk_ms median="
        f"{statistics.median(ms):.3f} p90={p90:.3f} max={srt[-1]:.3f}; "
        f"rtf_per_stream={seconds / (sum(ms) / 1e3):.3f}")
    n = codec.frame_size * frames * 10
    phase_profile(torch,
                  lambda: _stream(torch, codec, sig_dev[:, :n], frames),
                  statistics.median(ms) * 10, "10 chunks (10 x median)",
                  top=8)


def _stream_path(torch, rows, path, codec, cpu, sig, frames, seconds):
    """``sig`` [B, T] through ``encode_chunk`` then ``decode_chunk`` in
    chunks of ``frames`` token frames, four kernel-1 launches a chunk (2
    encoder + 2 decoder LSTM layers) and no other, against the CPU path's
    stream on two rows (its decoder fed the card's tokens); then the chunk
    times (``_stream_times``)."""
    sig_dev = torch.as_tensor(sig, device="cuda")
    n_chunks = sig.shape[1] // (codec.frame_size * frames)
    K = codec.config.num_codebooks
    reset_counts()
    toks, wav, _ = _stream(torch, codec, sig_dev, frames)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{path} launches over {n_chunks} chunks: {json.dumps(counts)}")
    want = _launch_table(4 * n_chunks, 0)
    if counts != want:
        fail(f"{path}: expected launches {want}, got {counts}")
    _add_launches(rows, path, counts)
    if tuple(toks.shape) != (sig.shape[0], sig.shape[1] // codec.frame_size,
                             K) or tuple(wav.shape) != sig.shape:
        fail(f"{path} shapes: toks {tuple(toks.shape)}, sig "
             f"{tuple(wav.shape)}")
    if not bool(torch.isfinite(wav).all()):
        fail(f"{path}: non-finite waveform")

    t0 = time.perf_counter()
    t_cpu, y_cpu, _ = _stream(torch, cpu, np.ascontiguousarray(sig[:2]),
                              frames, toks_in=toks[:2].cpu())
    mism = int((toks[:2].cpu() != t_cpu).sum())
    match = 1.0 - mism / t_cpu.numel()
    y_err = float((wav[:2].cpu() - y_cpu).abs().max())
    y_lim = 1e-4 * float(y_cpu.abs().max())
    log(f"{path} rows 0-1 against the CPU stream: token_match={match:.6f} "
        f"({mism} of {t_cpu.numel()} differ); decode max_abs_diff="
        f"{y_err:.3e} (limit {y_lim:.3e}); cpu_seconds="
        f"{time.perf_counter() - t0:.1f}")
    if not match >= 0.999:
        fail(f"{path}: token_match {match} < 0.999")
    if not y_err <= y_lim:
        fail(f"{path}: decoded waveform disagrees with the CPU path")
    _stream_times(torch, path, codec, sig_dev, frames, seconds)


def phase_encodec_stream(torch, rows):
    from audiocodecs_tpu_torch.models.encodec import Encodec

    sr, K, frames, seconds = 24000, 8, 6, 10.0
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=K)
    sig, = _noise(np.random.default_rng(6), [(8, int(sr * seconds))])
    _stream_path(torch, rows, "encodec_24k_stream", codec, cpu, sig, frames,
                 seconds)


def phase_mimi(torch, rows):
    from audiocodecs_tpu_torch.models.mimi import Mimi

    sr, K, seconds = 24000, 8, 10.0
    codec, cpu = _server_pair(torch, Mimi, sr, sr, num_codebooks=K)
    T = int(sr * seconds)
    requests = _noise(np.random.default_rng(7), [(8, T), (8, T), (1, 79201)])
    hop, stride = 960, codec.model_config.downsample_stride

    def shapes(shape):
        N = math.ceil(math.ceil(shape[1] / hop) / stride)
        return (shape[0], N, K), (shape[0], N * hop * stride)

    path = "mimi_24k"
    none = _launch_table(0, 0)
    _batch_path(torch, rows, path, codec, cpu, requests, none, shapes,
                (codec._encode, codec._decode, codec._decode_tower))

    # streaming, one 80 ms frame a chunk, against the card's batch path
    sig_dev = torch.as_tensor(requests[0], device="cuda")
    reset_counts()
    toks, wav, _ = _stream(torch, codec, sig_dev, 1)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{path} stream launches: {json.dumps(counts)}")
    if counts != none:
        fail(f"{path} stream: expected no launches, got {counts}")
    batch = codec.sig_to_toks(sig_dev)
    if tuple(toks.shape) != tuple(batch.shape) or tuple(wav.shape) != (
            8, T):
        fail(f"{path} stream shapes: toks {tuple(toks.shape)}, sig "
             f"{tuple(wav.shape)}")
    mism = int((toks != batch).sum())
    match = 1.0 - mism / batch.numel()
    y_batch = codec.toks_to_sig(toks)
    y_err = float((wav - y_batch).abs().max())
    y_lim = 1e-4 * float(y_batch.abs().max())
    log(f"{path} stream against batch on the card: token_match={match:.6f} "
        f"({mism} of {batch.numel()} differ); waveform max_abs_diff="
        f"{y_err:.3e} (limit {y_lim:.3e})")
    if not match >= 0.999:
        fail(f"{path} stream: token_match {match} < 0.999")
    if not y_err <= y_lim:
        fail(f"{path} stream: waveform disagrees with batch decode")
    _stream_times(torch, path, codec, sig_dev, 1, seconds)


def phase_wavtokenizer(torch, rows):
    """WavTokenizer-24k: the encoder's 2 LSTM layers and 4 causal blocks on
    the kernels, the Vocos head (768 wide, 12 blocks) on library calls."""
    from audiocodecs_tpu_torch.models.wavtokenizer import WavTokenizer
    from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

    sr, hop = 24000, 320
    codec, cpu = _server_pair(torch, WavTokenizer, sr, sr)
    requests = _noise(np.random.default_rng(8),
                      [(8, 10 * sr), (8, 10 * sr), (1, 79201)])

    def shapes(shape):
        # the head's ISTFT trims n_fft/2 a side: (N - 1) hops
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, 1), (shape[0], (N - 1) * hop)

    _batch_path(torch, rows, "wavtokenizer_24k", codec, cpu, requests,
                _launch_table(2, 4), shapes,
                (lambda f: vq_encode(f, codec.codebook)[..., None],
                 lambda t: vq_decode(t[..., 0], codec.codebook),
                 lambda q: codec._feats_to_sig(q, None)),
                profile_decode="decode from features (Vocos head)")


def phase_encodec_vocos(torch, rows):
    """EnCodec-24k's encoder, K = 8 (AdaLN row 2, 6 kbps), and the Vocos
    head (``VocosConfig()``) in place of the SEANet decoder."""
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.nn.vocos import apply_vocos
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop = 24000, 8, 320
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=K,
                              use_vocos=True)
    if codec._bandwidth_id != 2:
        fail(f"encodec_vocos: bandwidth id {codec._bandwidth_id}, want 2")
    requests = _noise(np.random.default_rng(9),
                      [(8, 10 * sr), (8, 10 * sr), (1, 79201)])

    def shapes(shape):
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, K), (shape[0], (N - 1) * hop)

    _batch_path(torch, rows, "encodec_vocos_24k", codec, cpu, requests,
                _launch_table(2, 4), shapes,
                (lambda f: rvq_encode(f, codec.codebooks, K),
                 lambda t: rvq_decode(t, codec.codebooks),
                 lambda q: apply_vocos(codec.vocos, q, codec.vocos_config,
                                       cond_id=codec._bandwidth_id)),
                profile_decode="decode from features (Vocos head)")


def phase_encodec_48k(torch, rows):
    """EnCodec-48k's chunking (1 s windows, 1 % overlap, normalized,
    non-causal), mono and without time group norm as the JAX package has
    it: 10 s is 11 windows a stream, so B = 8 is 88 windows of 150 frames
    through one encoder call, the LSTMs at (150, 88, 512) in 3 launches a
    layer (32 rows a launch at H = 512). The CPU checks a B = 1 x 2.97 s
    request (3 windows): the 88 windows would take minutes there."""
    from audiocodecs_tpu_torch.models.encodec import (
        Encodec, EncodecModelConfig)

    sr, K = 48000, 8
    mc = EncodecModelConfig(sampling_rate=sr, use_causal_conv=False,
                            normalize=True, chunk_length_s=1.0, overlap=0.01,
                            num_quantizers=16)
    L, S = mc.chunk_length, mc.chunk_stride
    frames = L // mc.hop_length
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=K,
                              model_config=mc)
    # the CPU's request: 2.97 s, the longest that is 3 windows
    requests = _noise(np.random.default_rng(10),
                      [(8, 10 * sr), (8, 10 * sr), (1, 3 * S)])
    log(f"encodec_48k_chunked: CPU parity on request 2, B = 1 x {3 * S} "
        f"samples (3 windows), not on the timed B = 8 x 10 s (88 windows)")

    def windows(shape):
        return shape[0] * max(1, math.ceil(shape[1] / S))

    def launches(shape):
        # 2 layers a LSTM, encoder and decoder, 32 rows a launch
        return _launch_table(4 * math.ceil(windows(shape) / 32), 0)

    def shapes(shape):
        n = windows(shape) // shape[0]
        return (shape[0], n * frames, K), (shape[0], S * (n - 1) + L)

    _batch_path(torch, rows, "encodec_48k_chunked", codec, cpu, requests,
                launches, shapes, None, parity_rows=None)


def phase_past(torch, rows):
    """PAST-16k (streamable): the causal SEANet's 4 LSTM layers and 8
    blocks on the kernels a roundtrip; then the first request streamed in
    80 ms chunks (4 frames), 4 LSTM launches a chunk."""
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop = 16000, 8, 320
    codec, cpu = _server_pair(torch, PAST, sr, sr, num_codebooks=K)
    requests = _noise(np.random.default_rng(11),
                      [(8, 10 * sr), (8, 10 * sr), (1, 80001)])

    _batch_path(torch, rows, "past_16k", codec, cpu, requests,
                _launch_table(4, 8), _hop_shapes(hop, K),
                (lambda f: rvq_encode(codec._project(f), codec.codebooks, K),
                 lambda t: rvq_decode(t, codec.codebooks),
                 lambda q: codec._decode(codec._unproject(q))))
    _stream_path(torch, rows, "past_16k_stream", codec, cpu, requests[0], 4,
                 10.0)


def _bigcodec_frames(cfg, n_samples: int) -> int:
    """Token frames of BigCodec's encoder: each strided conv (k = 2s, pad
    ⌈s/2⌉ a side) floors."""
    t = n_samples
    for s in cfg.up_ratios:
        t = (t + 2 * math.ceil(s / 2) - 2 * s) // s + 1
    return t


def _bigcodec_shapes(mc):
    """shapes(sig_shape) → (toks, sig) of BigCodec (one codebook)."""
    def shapes(shape):
        N = _bigcodec_frames(mc, shape[1])
        return (shape[0], N, 1), (shape[0], N * mc.hop_length)
    return shapes


def phase_bigcodec(torch, rows):
    """BigCodec-16k at its published width (ngf 48, the 2 + 2 LSTM layers at
    H = 1536 on the wide instance, one 8192 x 8 codebook) as in 9: two
    B = 8 x 10 s requests and one ragged B = 1, four wide kernel-1 launches
    (one a layer: 8 rows) and nine kernel-3 launches (the decoder's units of
    C = 192, 96, 48) a roundtrip, the fused units packed on the first decode
    only; parity on the ragged request and two rows of the first; features
    are the encoder's 1024-d output (``latent=False``)."""
    from audiocodecs_tpu_torch.models.bigcodec import BigCodec
    from audiocodecs_tpu_torch.ops.dac_resunit import pack_resunit_weights

    sr = 16000
    codec, cpu = _server_pair(torch, BigCodec, sr, sr, latent=False)
    mc = codec.model_config
    requests = _noise(np.random.default_rng(12),
                      [(8, 10 * sr), (8, 10 * sr), (1, 80001)])

    q = codec.quantizer
    _batch_path(torch, rows, "bigcodec_16k", codec, cpu, requests,
                _launch_table(4, 0, dac=9, wide=4), _bigcodec_shapes(mc),
                (lambda f: q.encode(f)[..., None],
                 lambda t: q.decode(t[..., 0]),
                 lambda z: codec._feats_to_sig(z, None)),
                packs=(lambda: pack_resunit_weights.packs, 9))


def _rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def _tier(torch, rows, label, exact, tier, cpu, sig, want, kind, frames,
          exact_ms=None, units=True):
    """A serving tier of a codec: ``sig`` through ``tier.sig_to_toks`` →
    ``toks_to_sig`` with the launches counted (``want``, by form), tokens
    equal bit for bit to the exact tier's, the waveform's rms and max
    deviation from the exact tier on the same tokens; then the decode of
    the first row's first ``frames`` token frames on the card against the
    CPU path of the same tier (none where ``cpu`` is None), and the warm
    roundtrip of the tier beside the exact tier's (``exact_ms``, timed here
    where None).

    For the exact forms (``kind`` "exact") the decode is held within 1e-4
    of max|sig|. Where the tier rounds to bf16 (``kind`` "one pass": bf16
    activations, or fp32 with bf16-rounded operands) two correct decodes
    part wherever a sum, taken in another order, straddles a rounding
    boundary, and every later rounding carries that on: end to end the
    card's and the CPU's decodes are near-independent draws of the tier's
    own error (the CPU against itself, with another conv implementation,
    reads 0.26-1.02 of the tier's move: ``tools/tier_divergence.py``). So
    the decode is held only to no more than the tier's move there, and the
    tight check is ``_units_teacher_forced``: each of a DAC-style
    decoder's residual units fed the CPU path's own input (``units``; the
    SEANet blocks' kernel is held to its plain version one rounding point
    at a time in ``phase_resblock_default`` instead)."""
    from audiocodecs_tpu_torch.models.dac import residual_unit_io

    reset_counts()
    toks = tier.sig_to_toks(sig)
    y = tier.toks_to_sig(toks)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{label} launches: {json.dumps(counts)}")
    if counts != want:
        fail(f"{label}: expected launches {want}, got {counts}")
    _add_launches(rows, label, counts)
    if not torch.equal(toks, exact.sig_to_toks(sig)):
        fail(f"{label}: tokens differ from the exact tier's")
    if y.dtype != torch.float32 or not bool(torch.isfinite(y).all()):
        fail(f"{label}: waveform {y.dtype}, or not finite")
    y_exact = exact.toks_to_sig(toks)
    move_rms, move_max = _rms(y - y_exact), float((y - y_exact).abs().max())
    sig_dev = torch.as_tensor(sig, device="cuda")
    rt_ms = cuda_ms(torch, lambda: tier.roundtrip(sig_dev), reps=5)
    rt_exact = exact_ms if exact_ms is not None else cuda_ms(
        torch, lambda: exact.roundtrip(sig_dev), reps=5)
    B, seconds = sig.shape[0], sig.shape[1] / tier.sample_rate
    log(f"{label} B={B} x {seconds} s: roundtrip {rt_ms:.3f} ms warm "
        f"(exact tier {rt_exact:.3f} ms, ratio {rt_ms / rt_exact:.3f}); "
        f"tokens equal to the exact tier's; waveform off the exact tier: "
        f"rms={move_rms:.3e} max={move_max:.3e} (max|sig| "
        f"{float(y_exact.abs().max()):.3f})")
    res = {"roundtrip_ms": rt_ms, "exact_roundtrip_ms": rt_exact,
           "move_rms": move_rms, "move_max": move_max, "sig_dev": sig_dev}
    if cpu is None:
        return res
    part = toks[:1, :frames]
    y_card, y_ex = tier.toks_to_sig(part), exact.toks_to_sig(part)
    t0 = time.perf_counter()
    with (residual_unit_io(cpu.decoder) if units
          else contextlib.nullcontext(({}, {}))) as (ins, outs):
        y_cpu = cpu.toks_to_sig(part.cpu())
    cpu_s = time.perf_counter() - t0
    diff = y_card.cpu() - y_cpu
    part_move = _rms(y_card - y_ex)
    scale = float(y_cpu.abs().max())
    if kind == "one pass":
        lim, got, ok = part_move, _rms(diff), _rms(diff) <= part_move
    else:
        lim, got = 1e-4 * scale, float(diff.abs().max())
        ok = got <= lim
    log(f"{label}: card vs CPU (same tier, {part.shape[1]} frames): "
        f"{'rms' if kind == 'one pass' else 'max'}={got:.3e} (limit "
        f"{lim:.3e}), max={float(diff.abs().max()):.3e} "
        f"({float(diff.abs().max()) / scale:.3e} of max|sig|), "
        f"cpu_seconds={cpu_s:.1f}")
    if not ok:
        fail(f"{label}: the card's decode is off the CPU path's by {got}, "
             f"limit {lim}")
    if kind == "one pass" and units:
        _units_teacher_forced(torch, label, tier, exact, ins, outs)
    res["cpu_err"] = got
    return res


def _units_teacher_forced(torch, label, tier, exact, ins, outs):
    """Each residual unit of the tier's decoder on the card (fused or not),
    fed the input that the CPU path's unit got in the same tier (``ins``),
    against that unit's CPU output (``outs``): rms(card − CPU) at most
    ``UNIT_SHARE`` of the unit's own move, rms(card tier − card exact) on
    the same input. The control, the card's exact unit in the tier's
    place, must read above that share: else the check could not tell the
    tier from exact fp32."""
    t_units = dict(tier.decoder.named_modules())
    e_units = dict(exact.decoder.named_modules())
    worst, control = 0.0, math.inf
    with torch.inference_mode():
        for name, x in ins.items():
            xd = x.to("cuda")
            card = t_units[name](xd).float()
            ex = e_units[name](xd.float())
            move = _rms(card - ex)
            if move == 0.0:
                fail(f"{label}: unit {name} does not move off exact fp32")
            want = outs[name].float()
            worst = max(worst, _rms(card.cpu() - want) / move)
            control = min(control, _rms(ex.cpu() - want) / move)
    log(f"{label}: {len(ins)} residual units fed the CPU path's input: "
        f"rms(card - CPU) at most {worst:.4f} of the unit's move off exact "
        f"(limit {UNIT_SHARE}); control, exact fp32 in the tier's place: at "
        f"least {control:.4f} (must exceed the limit)")
    if not ins or worst > UNIT_SHARE or control <= UNIT_SHARE:
        fail(f"{label}: units fed the CPU path's input: card vs CPU "
             f"{worst} of the move, control {control}, limit {UNIT_SHARE}")


def phase_dac_tiers(torch, rows):
    """DAC-44.1k (9 codebooks, seeded random weights) in the serving tiers
    of ``audiocodecs_tpu_torch.serving``: latency and fast at B = 1, the
    throughput tier (bf16 activations, polynomial snake) at B = 4 and 8,
    six B4 launches a decode in the tier's form; and at B = 8 the
    throughput tier with its units unfused (bf16 cuDNN and snakes) beside
    the fused one. Then the unit's three forms that no preset selects at
    B = 1 through the same entry points, for their launches, tokens and
    roundtrip only: ``phase_dac_resunit_forms`` holds them to their plain
    versions, so no CPU decode."""
    from audiocodecs_tpu_torch.models.dac import DAC, ResidualUnit
    from audiocodecs_tpu_torch.ops.dac_resunit import form_name
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    sr = 44100
    exact = DAC(sr, sr, num_codebooks=9, device="cuda",
                generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu() for k, v in exact.state_dict().items()}
    rng = np.random.default_rng(13)
    T = 10 * sr
    cases = [("latency", 1, apply_serving_preset("dac", "balanced", 1)),
             ("fast", 1, apply_serving_preset("dac", "fast", 1)),
             ("throughput", 4, apply_serving_preset("dac", "balanced", 4)),
             ("throughput", 8, apply_serving_preset("dac", "balanced", 8))]
    for form in ("exact_poly", "default_poly_f32", "default_bf16"):
        precision, poly, dt = _NEW_FORMS[form]
        cases.append((f"form_{form}", 1, {
            "decode_dtype": getattr(torch, dt),
            "decode_precision": precision, "snake_poly": poly}))
    out, exact_ms = {}, {}
    for name, B, kw in cases:
        tier = DAC(sr, sr, num_codebooks=9, device="cuda", state_dict=state,
                   **kw)
        cpu = None if name.startswith("form_") else DAC(
            sr, sr, num_codebooks=9, device="cpu", state_dict=state, **kw)
        form = form_name(kw["decode_precision"], kw["snake_poly"],
                         kw["decode_dtype"])
        want = (_launch_table(0, 0, dac=6) if form == "exact"
                else _launch_table(0, 0, **{form: 6}))
        kind = "exact" if kw["decode_precision"] == "exact" else "one pass"
        sig = _noise(rng, [(B, T)])[0]
        label = f"dac_44k_{name}_b{B}"
        res = _tier(torch, rows, label, exact, tier, cpu, sig, want, kind,
                    frames=87, exact_ms=exact_ms.get(B))
        exact_ms.setdefault(B, res["exact_roundtrip_ms"])
        if name == "throughput" and B == 8:
            units = [m for m in tier.modules()
                     if isinstance(m, ResidualUnit) and m.fused]
            for m in units:
                m.fused = False
            sig_dev = res["sig_dev"]
            res["unfused_roundtrip_ms"] = cuda_ms(
                torch, lambda: tier.roundtrip(sig_dev), reps=5)
            for m in units:
                m.fused = True
            fused_ms = cuda_ms(torch, lambda: tier.roundtrip(sig_dev),
                               reps=5)
            log(f"{label}: units unfused (bf16 cuDNN and snakes) "
                f"{res['unfused_roundtrip_ms']:.3f} ms against fused "
                f"{res['roundtrip_ms']:.3f}, {fused_ms:.3f} ms (B4's "
                f"bf16-poly form)")
            phase_profile(torch, lambda: tier.roundtrip(sig_dev),
                          fused_ms)
        del res["sig_dev"]
        out[label] = res
        del tier, cpu
    return out


def phase_bigcodec_tier(torch, rows):
    """BigCodec-16k's balanced tier (bf16 decoder activations, polynomial
    snake, the decoder LSTM an fp32 island) at B = 8 x 10 s: four wide
    kernel-1 launches and nine B4 launches in the bf16-poly form a
    roundtrip, as ``_tier``; profiled."""
    from audiocodecs_tpu_torch.models.bigcodec import BigCodec
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    sr = 16000
    exact = BigCodec(sr, sr, latent=False, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu() for k, v in exact.state_dict().items()}
    kw = apply_serving_preset("bigcodec")
    tier = BigCodec(sr, sr, latent=False, device="cuda", state_dict=state,
                    **kw)
    cpu = BigCodec(sr, sr, latent=False, device="cpu", state_dict=state,
                   **kw)
    sig = _noise(np.random.default_rng(14), [(8, 10 * sr)])[0]
    res = _tier(torch, rows, "bigcodec_16k_balanced", exact, tier, cpu, sig,
                _launch_table(4, 0, wide=4, default_poly_bf16=9), "one pass",
                frames=80)
    sig_dev = res.pop("sig_dev")
    phase_profile(torch, lambda: tier.roundtrip(sig_dev),
                  res["roundtrip_ms"])
    return res


def _server_requests(sr: int, n: int = 16):
    """The JAX ``examples/serve.py`` main()'s stream: durations uniform in
    0.5-8 s from ``default_rng(0)``, request i a sine at 200 + 50 i Hz."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        t = np.arange(int(float(rng.uniform(0.5, 8.0)) * sr)) / sr
        out.append(np.sin(2 * np.pi * (200 + 50 * i) * t).astype(np.float32))
    return out


def phase_server(torch, rows):
    """``CodecServer`` (``audiocodecs_tpu_torch/examples/serve.py``) over
    BigCodec-16k and EnCodec-24k (each exact, then in its balanced serving
    tier, as the entry point builds it), reached by registry name, seeded
    random weights: buckets (1, 2, 5, 10) s, max_batch 8, max_wait_ms 5, the JAX
    main()'s 16 requests submitted at once. Every reply must have its
    request's length, be finite and equal, bit for bit, the row of
    ``codec.roundtrip`` on the padded batch it ran in (the same code on the
    same device and shapes); each batch launches one roundtrip's kernels. A
    request whose batch failed fails the phase."""
    from audiocodecs_tpu_torch.examples.serve import CodecServer
    from audiocodecs_tpu_torch.models import get_codec_class
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    # (label, family, quality): each codec exact and in its balanced tier,
    # as the entry point's main() builds it by default
    per_batch = {("bigcodec", "bigcodec", "exact"):
                 _launch_table(4, 0, dac=9, wide=4),
                 ("bigcodec_balanced", "bigcodec", "balanced"):
                 _launch_table(4, 0, wide=4, default_poly_bf16=9),
                 ("encodec", "encodec", "exact"): _launch_table(4, 8),
                 ("encodec_balanced", "encodec", "balanced"):
                 _launch_table(4, 4, seanet_resblock_default_bf16=4)}
    for (name, family, quality), each in per_batch.items():
        cls = get_codec_class(family)
        sr = getattr(cls, "DEFAULT_ORIG_SR", 24000)
        codec = cls(sr, sr, device="cuda",
                    generator=torch.Generator().manual_seed(0),
                    **apply_serving_preset(family, quality))
        t0 = time.perf_counter()
        server = CodecServer(codec, buckets_s=(1.0, 2.0, 5.0, 10.0),
                             max_batch=8, max_wait_ms=5.0)
        warm_s = time.perf_counter() - t0
        reqs = _server_requests(sr)
        try:
            reset_counts()
            t0 = time.perf_counter()
            replies = [server.submit(w) for w in reqs]
            try:
                recs = [r.get(timeout=600) for r in replies]
            except Exception as e:  # a worker's error, delivered to get()
                fail(f"server {name}: a request failed: {e!r}")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            server.stop()
        batches = {id(r.batch): r.batch for r in replies}
        want = {k: v * len(batches) for k, v in each.items()}
        log(f"server {name}: {len(reqs)} requests in {len(batches)} "
            f"batches of 8 rows, buckets "
            f"{sorted(b.shape[1] for b in batches.values())}; launches "
            f"{json.dumps(counts)}")
        if counts != want:
            fail(f"server {name}: expected launches {want}, got {counts}")
        _add_launches(rows, f"server_{name}", counts)
        rt = {}
        for w, r, y in zip(reqs, replies, recs):
            if y.shape != w.shape or not np.isfinite(y).all():
                fail(f"server {name}: reply of shape {y.shape} for a "
                     f"request of {w.shape}, or not finite")
            if id(r.batch) not in rt:
                rt[id(r.batch)] = codec.roundtrip(r.batch).cpu().numpy()
            if not np.array_equal(y, rt[id(r.batch)][r.row, : len(w)]):
                fail(f"server {name}: a reply differs from its batch's "
                     f"roundtrip row by "
                     f"{np.abs(y - rt[id(r.batch)][r.row, : len(w)]).max()}")
        audio = sum(len(w) for w in reqs) / sr
        lat = sorted((r.done - r.submitted) * 1e3 for r in replies)
        log(f"server {name}: {len(reqs)} requests served, {audio:.3f} s of "
            f"audio in {wall:.3f} s wall ({audio / wall:.3f}x real time); "
            f"latency p50={statistics.median(lat):.3f} ms p90="
            f"{lat[min(len(lat) - 1, math.ceil(0.9 * len(lat)) - 1)]:.3f} "
            f"ms; every reply equals its batch's roundtrip row; warm-up "
            f"(first roundtrip, builds and packs) {warm_s:.3f} s")
        del codec, server


def _function_grad(torch, fn, plain, args, g_outs):
    """The Function ``fn`` (kernel forward, backward recomputed through the
    plain version) against autograd through ``plain`` on the same inputs
    on the card: the worst forward error relative to max(1, max|plain
    output|) (the kernel against its plain version at this shape), the
    worst gradient error relative to the plain gradient's max|g| (the
    backward's wiring: both sides differentiate the plain version), and
    the ms of one backward of each (CUDA events; the graphs are kept, so
    the Function's backward recomputes every time)."""
    from audiocodecs_tpu_torch.nn.layers import exact_fp32

    leaves = [a for a in args if a.requires_grad]
    outs, grads, ms = [], [], []
    with exact_fp32():
        for f in (fn, plain):
            out = f(*args)
            out = out if isinstance(out, tuple) else (out,)
            grads.append(torch.autograd.grad(out, leaves, g_outs,
                                             retain_graph=True))
            ms.append(cuda_ms(torch, lambda: torch.autograd.grad(
                out, leaves, g_outs, retain_graph=True), reps=5, warmup=1))
            outs.append(tuple(o.detach() for o in out))
            del out
    fwd = max(float((o - w).abs().max()) / max(1.0, float(w.abs().max()))
              for o, w in zip(*outs))
    err = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for g, w in zip(*grads))
    return fwd, err, ms[0], ms[1]


def phase_train_grads(torch, rows, card):
    """Each kernel's Function against the plain version on the card, at
    the training path's shapes: the forward (the kernel) within 1e-5 of
    max(1, max|out|), the gradient within 1e-4 of max|g|."""
    from audiocodecs_tpu_torch.nn.layers import pad1d
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit, dac_resunit_reference, pack_resunit_weights)
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence, lstm_recurrence_reference)
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        pack_resblock_weights, seanet_resblock, seanet_resblock_packed,
        seanet_resblock_packed_reference, seanet_resblock_reference)

    gen = torch.Generator().manual_seed(9)
    by_name = {r["name"]: r for r in rows}

    def req(t):
        return t.to("cuda").requires_grad_()

    def g_like(*shape):
        return (torch.randn(*shape, generator=gen)).to("cuda")

    def record(name, label, fwd, err, bwd_ms, plain_bwd_ms):
        log(f"{name} training shape {label}: forward max_rel_err={fwd:.3e} "
            f"(limit 1e-5), gradient max_rel_err={err:.3e} (limit 1e-4) "
            f"backward_ms={bwd_ms:.4f} plain_backward_ms={plain_bwd_ms:.4f} "
            f"({card})")
        if not fwd <= 1e-5:
            fail(f"{name}: the kernel disagrees with its plain version at "
                 f"{label}: {fwd}")
        if not err <= 1e-4:
            fail(f"{name}: the Function's gradient disagrees with the plain "
                 f"version's at {label}: {err}")
        row = by_name[name]
        row["grad_fwd_max_err"] = max(row.get("grad_fwd_max_err", 0.0), fwd)
        row["grad_max_err"] = max(row.get("grad_max_err", 0.0), err)
        row["grad_backward_ms"] = row.get("grad_backward_ms", 0.0) + bwd_ms
        row["plain_backward_ms"] = (row.get("plain_backward_ms", 0.0)
                                    + plain_bwd_ms)
        row.setdefault("grad_shapes", []).append(label)

    T, B, H = TRAIN_GRAD_LSTM
    args = [req(a) for a in _lstm_inputs(torch, gen, T, B, H, "cpu")]
    record("lstm_recurrence", f"T={T} B={B} H={H}", *_function_grad(
        torch, lstm_recurrence, lstm_recurrence_reference, args,
        [g_like(T, B, H), g_like(B, H), g_like(B, H)]))

    for B, C, T in TRAIN_GRAD_BLOCKS:
        x, weights = _resblock_inputs(torch, gen, B, C, T, "cpu")
        x, weights = req(x), [req(w) for w in weights]
        packed = pack_resblock_weights(weights[0], weights[2], weights[4])

        def halo(x):
            return pad1d(x[..., :3], 2, 0, mode="reflect")[..., :2].contiguous()

        record("seanet_resblock", f"B={B} C={C} T={T}", *_function_grad(
            torch, lambda x, *w: seanet_resblock(x, halo(x), *w,
                                                 packed=packed),
            lambda x, *w: seanet_resblock_reference(x, halo(x), *w),
            [x, *weights], [g_like(B, C, T)]))

    B, C, T = TRAIN_GRAD_PACKED
    x, (w1, b1, w2, b2, ws, bs) = _resblock_inputs(torch, gen, B, C, T, "cpu")
    args = [req(a) for a in (x.transpose(1, 2).contiguous(),
                             w1.permute(2, 1, 0).contiguous(), b1,
                             w2[..., 0].T.contiguous(), b2,
                             ws[..., 0].T.contiguous(), bs)]
    record("seanet_resblock_packed", f"B={B} C={C} T={T}", *_function_grad(
        torch, seanet_resblock_packed, seanet_resblock_packed_reference,
        args, [g_like(B, T, C)]))

    B, C, T, d = TRAIN_GRAD_UNIT
    x, weights = _unit_inputs(torch, gen, B, C, T, "cpu")
    x, weights = req(x), [req(w) for w in weights]
    packed = pack_resunit_weights(weights[0], weights[3])
    record("dac_resunit", f"B={B} C={C} T={T} d={d}", *_function_grad(
        torch, lambda x, *w: dac_resunit(x, *w, d, packed=packed),
        lambda x, *w: dac_resunit_reference(x, *w, d), [x, *weights],
        [g_like(B, C, T)]))


def _train_batches(rng, B, seconds, sr, n):
    """``examples/train_codec.py``'s synthetic batches: the example signal
    at a random gain in [0.5, 1) plus N(0, 0.05²) noise."""
    from audiocodecs_tpu_torch.utils.audio import example_signal

    base = example_signal(sr, seconds)
    out = []
    for _ in range(n):
        noise = rng.standard_normal((B, base.shape[0])).astype(np.float32)
        out.append((base[None] * rng.uniform(0.5, 1.0)
                    + 0.05 * noise).astype(np.float32))
    return out


def _trainer(torch, model):
    """EnCodec's published recipe on one card: Adam at 3e-4, betas (0.5,
    0.9); EMA codebooks (decay 0.99); the spectral term at weight 1.0,
    ramped in over two updates from the first."""
    from audiocodecs_tpu_torch.parallel.train import (
        init_codec_opt_state, make_codec_train_step)

    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4,
                                 betas=(0.5, 0.9))
    state = init_codec_opt_state(optimizer, model, 8)
    step = make_codec_train_step(model, 8, spec_weight=1.0, ema_decay=0.99,
                                 spec_delay=0, spec_ramp=2)
    return state, step


def _rel_l2(a, b) -> float:
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _train_parity(torch, sr):
    """Step 1 on the card against the port's CPU path: same weights, same
    B = 2 x 1 s batch. Losses within 1e-4 relative, each gradient within
    1e-3 relative L2, the tokens of the batch (token_match >= 0.999), the
    EMA codebooks after the update within 1e-4 of max|codebook|."""
    from audiocodecs_tpu_torch.models.encodec import Encodec

    model, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=8)
    sig, = _train_batches(np.random.default_rng(1), 2, 1.0, sr, 1)
    toks, t_cpu = model.sig_to_toks(sig).cpu(), cpu.sig_to_toks(sig)
    mism = int((toks != t_cpu).sum())
    match = 1.0 - mism / t_cpu.numel()
    t0 = time.perf_counter()
    mets = []
    for m in (model, cpu):
        state, step = _trainer(torch, m)
        mets.append({k: float(v) for k, v in step(state, sig).items()})
    cpu_s = time.perf_counter() - t0
    m_err = {k: abs(mets[0][k] - mets[1][k]) / max(abs(mets[1][k]), 1e-30)
             for k in ("loss", "recon", "commit", "spec")}
    g_err = {}
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        if p.grad is None or q.grad is None:
            if not (p.grad is None and q.grad is None and name == "codebooks"):
                fail(f"train parity: {name} has a gradient on one side only")
            continue
        g_err[name] = _rel_l2(p.grad.cpu(), q.grad)
    worst = max(g_err, key=g_err.get)
    cb_err = float((model.codebooks.detach().cpu() - cpu.codebooks.detach())
                   .abs().max()) / float(cpu.codebooks.detach().abs().max())
    log(f"train step 1, card vs CPU (B=2 x 1 s): token_match={match:.6f} "
        f"({mism} of {t_cpu.numel()} differ); metrics rel err "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in m_err.items()})} "
        f"(limit 1e-4); gradient rel L2 worst {g_err[worst]:.3e} ({worst}; "
        f"limit 1e-3) over {len(g_err)} tensors; EMA codebooks after the "
        f"update max_rel_err={cb_err:.3e} (limit 1e-4); cpu_seconds="
        f"{cpu_s:.1f}")
    if not match >= 0.999:
        fail(f"train parity: token_match {match} < 0.999")
    if not max(m_err.values()) <= 1e-4:
        fail(f"train parity: metrics differ from the CPU path: {m_err}")
    if not g_err[worst] <= 1e-3:
        fail(f"train parity: gradient of {worst} differs from the CPU path "
             f"by {g_err[worst]} (relative L2)")
    if not cb_err <= 1e-4:
        fail(f"train parity: EMA codebooks differ from the CPU path: {cb_err}")


def phase_train(torch, rows, card):
    """EnCodec-24 kHz training at its published width on the card: each
    kernel and its Function at the path's shapes (``phase_train_grads``),
    step 1 against the CPU path (``_train_parity``), then the counted run
    of ``TRAIN_STEPS`` steps on B = 8 x 1 s synthetic batches (4 B1 and 8
    B2 launches a step, every encoder and decoder gradient finite and
    nonzero after step 1), the warm step's time (median of steps 3-8, CUDA
    events), audio seconds a wall second, peak memory, and one profiled
    step: its split into forward, backward and update, the kernels each
    part launched, and the time of B1's and B2's recompute inside the
    backward (``_train_step_split``)."""
    from audiocodecs_tpu_torch.models.encodec import Encodec

    sr = 24000
    phase_train_grads(torch, rows, card)
    _train_parity(torch, sr)

    model = Encodec(sr, sr, num_codebooks=8, device="cuda",
                    generator=torch.Generator().manual_seed(0))
    state, step = _trainer(torch, model)
    batches = [torch.as_tensor(b, device="cuda") for b in _train_batches(
        np.random.default_rng(0), TRAIN_B, 1.0, sr, TRAIN_STEPS + 2)]
    torch.cuda.synchronize()

    # the counted run: the training path only
    reset_counts()
    recon, step_ms, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        met = step(state, batches[i])
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        recon.append(float(met["recon"]))
        if not all(math.isfinite(float(v)) for v in met.values()):
            fail(f"train step {i + 1}: non-finite metrics {met}")
        if i == 0:
            bad = [n for n, p in model.named_parameters() if n != "codebooks"
                   and (p.grad is None or not bool(torch.isfinite(p.grad).all())
                        or float(p.grad.abs().max()) == 0.0)]
            n_params = sum(1 for _ in model.parameters())
            log(f"train step 1 gradient coverage: {n_params - 1 - len(bad)} "
                f"of {n_params - 1} encoder and decoder tensors finite and "
                f"nonzero; codebooks (EMA) gradient "
                f"{'none' if model.codebooks.grad is None else 'present'}")
            if bad or model.codebooks.grad is not None:
                fail(f"train step 1: gradients missing, zero or non-finite: "
                     f"{bad[:8]}")
    counts = read_counts()
    log(f"encodec_24k_train launches over {TRAIN_STEPS} steps: "
        f"{json.dumps(counts)}; a step: {per_step[0]}")
    if counts != _launch_table(4 * TRAIN_STEPS, 8 * TRAIN_STEPS) or any(
            s != _launch_table(4, 8) for s in per_step):
        fail(f"encodec_24k_train: expected 4 B1 and 8 B2 launches a step, "
             f"got {per_step}")
    _add_launches(rows, "encodec_24k_train", counts)
    log(f"train recon over steps 1-{TRAIN_STEPS}: "
        f"{json.dumps([round(r, 6) for r in recon])}")

    warm = statistics.median(step_ms[TRAIN_TIMED])
    torch.cuda.reset_peak_memory_stats()
    step(state, batches[TRAIN_STEPS])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"train warm step B={TRAIN_B} x 1 s ({card}): median "
        f"{warm:.3f} ms over steps 3-{TRAIN_STEPS} "
        f"{json.dumps([round(t, 3) for t in step_ms])}; "
        f"audio_seconds_per_wall_second={TRAIN_B * 1.0 / (warm / 1e3):.3f}; "
        f"peak_mem_bytes={peak}")
    # the step's launches by part from the wrappers' counters, read where
    # the step enters and leaves its own ranges (``train.record_function``)
    from audiocodecs_tpu_torch.parallel import train as train_mod

    real, by_part = train_mod.record_function, {}

    @contextlib.contextmanager
    def counted(name):
        before = read_counts()
        with real(name):
            yield
        after = read_counts()
        by_part[name.rsplit(".", 1)[-1]] = {
            c: after[c] - before[c] for c in _KERNEL_NAMES}

    train_mod.record_function = counted
    try:
        before = read_counts()
        prof = phase_profile(torch,
                             lambda: step(state, batches[TRAIN_STEPS + 1]),
                             warm, what=f"train step ({card})")
        after = read_counts()
    finally:
        train_mod.record_function = real
    if {k: after[k] - before[k] for k in after} != _launch_table(4, 8):
        fail(f"train step: the profiled step did not launch 4 B1 and 8 B2: "
             f"{before} -> {after}")
    if prof is None:
        fail("train step: the profiler saw no device time, so the step's "
             "split cannot be read")
    lost = _lost_records(prof)[0]
    if lost:
        fail(f"train step: the profile holds no device record of {lost} "
             f"kernel launches")
    _train_step_split(prof, card, by_part)


# the device name of each counted wrapper's kernel (B3 runs B2's kernel)
_KERNEL_NAMES = {"lstm_recurrence": "lstm_recurrence_kernel",
                 "seanet_resblock": "seanet_resblock_kernel",
                 "dac_resunit": "dac_resunit_kernel"}
_STEP_PARTS = ("forward", "backward", "update")


def _train_step_split(prof, card, by_part):
    """The profiled train step taken apart by ``make_codec_train_step``'s
    own ranges ``codec_train_step.{forward,backward,update}``: each part's
    host time and device window, the package's kernels launched in each,
    both by the wrappers' counters read at the ranges' edges (``by_part``)
    and in the profile's device window: 4 B1 and 8 B2 in the forward, none
    in the backward or the update, by both; and the recompute ranges of
    B1's and B2's Functions inside the backward.

    The forward and the update launch from the calling thread, so their
    ranges' device spans hold their kernels. The backward's kernels are
    launched by autograd's device thread, outside the caller's range: on
    the one stream they run after the forward's last kernel and before the
    update's first, so that gap is the backward's device window (its idle
    time included)."""
    from torch.autograd import DeviceType

    spans, host, kernels = {}, {}, []
    for evt in prof.events():
        name = evt.name
        if evt.device_type == DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False):
                spans.setdefault(name, []).append(
                    (evt.time_range.start, evt.time_range.end))
            else:
                kernels.append((evt.time_range.start, name))
        elif name.startswith("codec_train_step."):
            host[name] = host.get(name, 0.0) + evt.cpu_time_total / 1e3
    for part in _STEP_PARTS:
        key = f"codec_train_step.{part}"
        if key not in host or (part != "backward"
                               and len(spans.get(key, ())) != 1):
            fail(f"train step: the profile has no single range {key} on "
                 f"the host and the device: {sorted(spans)}")
    fwd = spans["codec_train_step.forward"][0]
    upd = spans["codec_train_step.update"][0]
    windows = {"forward": fwd, "backward": (fwd[1], upd[0]), "update": upd}
    split, seen = {}, {}
    for part, (lo, hi) in windows.items():
        split[part] = {"host_ms": round(host[f"codec_train_step.{part}"], 3),
                       "device_window_ms": round((hi - lo) / 1e3, 3)}
        seen[part] = {c: sum(1 for t, n in kernels
                             if k in n and lo <= t < hi)
                      for c, k in _KERNEL_NAMES.items()}
    log(f"train step split (the profiled step, {card}): {json.dumps(split)}")
    log(f"train step kernel launches by part (counters): "
        f"{json.dumps(by_part)}; the package's kernels the profile holds in "
        f"each part's device window: {json.dumps(seen)}")
    want = {"lstm_recurrence": 4, "seanet_resblock": 8, "dac_resunit": 0}
    none = dict.fromkeys(want, 0)
    expected = {"forward": want, "backward": none, "update": none}
    if by_part != expected or seen != expected:
        fail(f"train step: expected 4 B1 and 8 B2 launches in the forward "
             f"and none in the backward or the update, got {by_part} by "
             f"the counters and {seen} in the profile")
    # each recompute range twice: on the host (its time there and its
    # kernels' device time) and on the device (the span of its kernels)
    ranges = {}
    for evt in prof.key_averages():
        if evt.key not in ("lstm_recurrence.backward",
                           "seanet_resblock.backward"):
            continue
        r = ranges.setdefault(evt.key, {})
        if evt.device_type == DeviceType.CUDA:
            r["device_span_ms"] = round(_device_us(evt) / 1e3, 3)
        else:
            r.update(count=evt.count,
                     host_ms=round(evt.cpu_time_total / 1e3, 3),
                     kernels_ms=round(_device_us(evt) / 1e3, 3))
    log(f"train step recompute inside the backward ({card}): "
        f"{json.dumps(ranges)}")


_KERNEL_GROUPS = (("lstm_recurrence", "lstm_recurrence_kernel"),
                  ("seanet_resblock", "seanet_resblock_kernel"),
                  ("seanet_resblock (bf16 MMA)",
                   "seanet_resblock_mma_kernel"),
                  ("dac_resunit", "dac_resunit_kernel"),
                  ("dac_resunit (bf16 MMA)", "dac_resunit_mma_kernel"),
                  ("fft (cuFFT)", "fft"), ("overlap-add (fold)", "col2im"),
                  ("layer_norm", "layer_norm"),
                  ("conv (cuDNN)", "cudnn"), ("conv (cuDNN)", "conv"),
                  ("matmul (cuBLAS)", "xmma_gemm"), ("conv (cuDNN)", "xmma"),
                  ("matmul (cuBLAS)", "gemm"), ("padding", "pad1d"),
                  ("softmax", "softmax"), ("elementwise", "elementwise"),
                  ("reduce", "reduce"))


def _device_us(evt) -> float:
    """Device time of a profiler event, under either attribute name."""
    us = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if us is None else us


# The profiler holds no device record of the first kernel launches of a
# session: none in a fresh process, 17 to 271 late in a run of this script
# (H100, torch 2.11); neither 0.2 s of idle time nor a session just before
# it changed that. So a profiled run starts after this many launches of a
# spin kernel of its own name, and only the launches inside the run's own
# range are its.
PROFILE_WARMUP_LAUNCHES = 1024
_WARMUP_KERNEL = "spin_kernel"  # torch.cuda._sleep's
_RUN_RANGE = "chip_smoke.profiled_run"
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def _lost_records(prof):
    """Kernel launch calls with no device record: inside the profiled run's
    range, and before it (the warm-up's); and the launch calls inside."""
    from torch.autograd import DeviceType

    kernels, calls, run = set(), [], None
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            if not evt.is_user_annotation():
                kernels.add(evt.correlation_id())
        elif evt.name() == _RUN_RANGE:
            run = (evt.start_ns(), evt.end_ns())
        elif evt.name() in _LAUNCH_CALLS:
            calls.append((evt.start_ns(), evt.correlation_id()))
    inside = [c for t, c in calls if run[0] <= t <= run[1]]
    before = [c for t, c in calls if t < run[0]]
    return (sum(1 for c in inside if c not in kernels),
            sum(1 for c in before if c not in kernels), len(inside))


def phase_profile(torch, fn, wall_ms, what="roundtrip", top=12):
    """Device time of one run of ``fn`` by kernel (torch.profiler), beside
    its wall time ``wall_ms``; the run follows ``PROFILE_WARMUP_LAUNCHES``
    launches of a spin kernel, which the breakdown leaves out, and is
    logged with its launch calls that the profile holds no device record
    of (``_lost_records``). Returns the profile (None if it saw no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        with record_function(_RUN_RANGE):
            fn()
            torch.cuda.synchronize()
    lost, warmup_lost, calls = _lost_records(prof)
    log(f"profile ({what}): {lost} of the run's {calls} kernel launch calls "
        f"without a device record; {warmup_lost} of the "
        f"{PROFILE_WARMUP_LAUNCHES} warm-up launches before it")
    kernels = []
    for evt in prof.key_averages():
        # a profiler range (record_function) also shows on the device as
        # the span of its kernels; it is no kernel of its own
        if evt.device_type != DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False) or (
                _WARMUP_KERNEL in evt.key):
            continue
        kernels.append((_device_us(evt) / 1e3, evt.count, evt.key))
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        log("profile: the profiler saw no device time (not measured)")
        return None
    groups = {}
    for ms, _, key in kernels:
        g = next((g for g, pat in _KERNEL_GROUPS if pat in key.lower()),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
    log(f"profile: device busy {busy:.3f} ms of a {wall_ms:.3f} ms {what} "
        f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}); by group (ms): "
        + json.dumps({g: round(v, 3) for g, v in
                      sorted(groups.items(), key=lambda kv: -kv[1])}))
    for ms, count, key in sorted(kernels, reverse=True)[:top]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {key[:100]}")
    return prof


def _resblock_module(torch, C, cfg, w):
    """A ``ResBlock`` on the card holding ``w`` (w1, b1, w2, b2, ws, bs)."""
    from audiocodecs_tpu_torch.nn.seanet import ResBlock

    blk = ResBlock(C, cfg).cuda()
    with torch.no_grad():
        for conv, (wt, bt) in zip((*blk.block, blk.shortcut),
                                  ((w[0], w[1]), (w[2], w[3]), (w[4], w[5]))):
            conv.w.copy_(wt)
            conv.b.copy_(bt)
    return blk


def _b2_default_check(torch, args, packed, label):
    """One shape of B2's one-pass form: the kernel's stages against its
    plain version one rounding point at a time (``default_errors``), and
    the model's launch equal to the stages launch bit for bit."""
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        default_errors, seanet_resblock, seanet_resblock_stages)

    with torch.inference_mode():
        out, h2, k3 = seanet_resblock_stages(*args, packed=packed)
        got = seanet_resblock(*args, packed=packed, precision="default")
        check = default_errors(out, h2, k3, *args)
        same = torch.equal(out, got)
    del out, h2, k3
    if not (check["ok"] and same):
        fail(f"{label}: one-pass kernel off its plain version: {check}, "
             f"model launch equal to the stages launch: {same}")
    return got, check


def phase_resblock_default(torch, peaks, rows):
    """B2's one-pass form (``precision="default"``) at the four EnCodec-24k
    decoder shapes (B = 8 x 10 s), on fp32 and on bf16 operands, and B3's
    entry in the form at (C, T) = (32, 240000) and (64, 120000): each
    held to its plain version one rounding point at a time (the k3 sum
    within 1e-5 of Σ|terms|, h2 within one bf16 ulp plus that, with the
    share that differs, the tail on the kernel's own h2 within 1e-5
    relative), timed on weights packed once beside its plain version and
    two library references of the same block unfused: in bf16 (cuDNN's
    bf16 convs, ELU and add: the reference's XLA path in the tier) and in
    fp32 on bf16-rounded operands; with its bound (one bf16 pass at 989
    TFLOP/s, or the bytes at the HBM rate). Fills each form's row of
    ``rows`` (made before the paths ran, so that it holds their
    launches)."""
    from audiocodecs_tpu_torch.nn.layers import DecodeForm, pad1d
    from audiocodecs_tpu_torch.nn.seanet import SEANetConfig, _resnet_plain
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        pack_resblock_weights, seanet_resblock, seanet_resblock_info,
        seanet_resblock_packed, seanet_resblock_reference)

    gen = torch.Generator().manual_seed(15)
    cfg = SEANetConfig()
    by_name = {row["name"]: row for row in rows}
    for dt_name in ("f32", "bf16"):
        dtype = torch.float32 if dt_name == "f32" else torch.bfloat16
        tot = dict.fromkeys(("ms", "plain_ms", "library_ms",
                             "library_f32_rounded_ms", "flops", "bytes"),
                            0.0)
        worst, per_shape = 0.0, []
        for B, C, T in RESBLOCK_SHAPES:
            x, w = _resblock_inputs(torch, gen, B, C, T, "cuda")
            halo = pad1d(x[..., :3], 2, 0, mode="reflect")[..., :2]
            args = [t.to(dtype).contiguous() for t in (x, halo, *w)]
            packed = pack_resblock_weights(w[0], w[2], w[4], "default")
            label = f"seanet_resblock default {dt_name} B={B} C={C} T={T}"
            got, check = _b2_default_check(torch, args, packed, label)
            blk = _resblock_module(torch, C, cfg, w)
            bf16_form = DecodeForm(torch.bfloat16, "default")
            f32_form = DecodeForm(torch.float32, "default")
            xb, xf = args[0].to(torch.bfloat16), args[0].float()
            with torch.inference_mode():
                plain = seanet_resblock_reference(*args, precision="default")
                err = float((got.float() - plain.float()).abs().max())
                del got, plain
                ms = cuda_ms(torch, lambda: seanet_resblock(
                    *args, packed=packed, precision="default"), reps=5)
                plain_ms = cuda_ms(torch, lambda: seanet_resblock_reference(
                    *args, precision="default"), reps=5)
                lib_ms = cuda_ms(torch, lambda: _resnet_plain(
                    xb, blk, cfg, (1, 1), bf16_form), reps=5)
                lib32_ms = cuda_ms(torch, lambda: _resnet_plain(
                    xf, blk, cfg, (1, 1), f32_form), reps=5)
            Hc = C // 2
            flops = 2.0 * B * T * (3 * C * Hc + Hc * C + C * C)
            esize = args[0].element_size()
            nbytes = (2 * B * C * T + 2 * B * C) * esize + 2 * (
                3 * C * Hc + Hc * C + C * C) + esize * (Hc + 2 * C)
            b_ms, b_by = bound(flops, nbytes, (BF16_PEAK, peaks[1]))
            info = seanet_resblock_info(C, Hc, "default", dtype)
            log(f"{label}: max_abs_err={err:.3e} check={json.dumps(check)} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms(unfused bf16 block)={lib_ms:.4f} "
                f"library_ms(unfused fp32 on bf16-rounded operands)="
                f"{lib32_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                f"kernel/bound={ms / b_ms:.2f} {json.dumps(info)}")
            per_shape.append({"B": B, "C": C, "T": T, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": lib_ms,
                              "library_f32_rounded_ms": lib32_ms,
                              "bound_ms": b_ms, "max_abs_err": err, **info,
                              **{k: v for k, v in check.items()
                                 if k != "ok"}})
            worst = max(worst, err)
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms),
                         ("library_f32_rounded_ms", lib32_ms),
                         ("flops", flops), ("bytes", nbytes)):
                tot[k] += v
            del x, w, args, packed, blk, xb, xf
        b_ms, b_by = bound(tot["flops"], tot["bytes"], (BF16_PEAK, peaks[1]))
        log(f"seanet_resblock default {dt_name}, four EnCodec-24k shapes: "
            f"kernel_ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
            f"library_ms(bf16)={tot['library_ms']:.4f} library_ms(fp32 "
            f"rounded)={tot['library_f32_rounded_ms']:.4f} bound_ms="
            f"{b_ms:.4f} ({b_by})")
        by_name[f"seanet_resblock_default_{dt_name}"].update({
            "status": "ported", "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "audiocodecs_tpu/ops/seanet_block_pallas.py:96",
            "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["library_ms"],
            "library_f32_rounded_ms": tot["library_f32_rounded_ms"],
            "per_shape": per_shape,
            "shape": f"sum over the four EnCodec-24k (C, T) shapes at B=8, "
                     f"{dt_name} operands, weights packed once; library: "
                     f"the block unfused in bf16 (library_f32_rounded_ms: "
                     f"in fp32 on bf16-rounded operands)"})

    # B3's entry in the one-pass form: the converted layout through the
    # same kernel, bit for bit the stages launch on that layout
    from audiocodecs_tpu_torch.ops.seanet_resblock import (
        _packed_args, seanet_resblock_packed_reference)

    for dt_name in ("f32", "bf16"):
        dtype = torch.float32 if dt_name == "f32" else torch.bfloat16
        tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "flops",
                             "bytes"), 0.0)
        worst = 0.0
        for B, C, T in PACKED_SHAPES:
            x, w = _resblock_inputs(torch, gen, B, C, T, "cuda")
            xt = x.transpose(1, 2).contiguous().to(dtype)
            pargs = [xt, *(t.to(dtype) for t in (
                w[0].permute(2, 1, 0).contiguous(), w[1],
                w[2][..., 0].T.contiguous(), w[3],
                w[4][..., 0].T.contiguous(), w[5]))]
            label = f"seanet_resblock_packed default {dt_name} B={B} C={C} " \
                    f"T={T}"
            conv = [t.contiguous() for t in _packed_args(*pargs)]
            want, _ = _b2_default_check(torch, conv, None, label)
            zcfg = SEANetConfig(pad_mode="constant")
            blk = _resblock_module(torch, C, zcfg, w)
            bf16_form = DecodeForm(torch.bfloat16, "default")
            with torch.inference_mode():
                got = seanet_resblock_packed(*pargs, precision="default")
                if not torch.equal(got, want.transpose(1, 2)):
                    fail(f"{label}: the entry's launch differs from the "
                         "block kernel's on the converted layout")
                plain = seanet_resblock_packed_reference(
                    *pargs, precision="default")
                err = float((got.float() - plain.float()).abs().max())
                del got, want, plain
                ms = cuda_ms(torch, lambda: seanet_resblock_packed(
                    *pargs, precision="default"), reps=5)
                plain_ms = cuda_ms(torch, lambda: (
                    seanet_resblock_packed_reference(
                        *pargs, precision="default")), reps=5)
                lib_ms = cuda_ms(torch, lambda: _resnet_plain(
                    xt.to(torch.bfloat16).transpose(1, 2), blk, zcfg, (1, 1),
                    bf16_form).transpose(1, 2), reps=5)
            Hc = C // 2
            flops = 2.0 * B * T * (3 * C * Hc + Hc * C + C * C)
            esize = xt.element_size()
            nbytes = 2 * B * C * T * esize + 2 * (
                3 * C * Hc + Hc * C + C * C) + esize * (Hc + 2 * C)
            b_ms, b_by = bound(flops, nbytes, (BF16_PEAK, peaks[1]))
            log(f"{label}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms(unfused bf16 block)="
                f"{lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
            worst = max(worst, err)
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("flops", flops),
                         ("bytes", nbytes)):
                tot[k] += v
            del x, w, xt, pargs, conv, blk
        b_ms, b_by = bound(tot["flops"], tot["bytes"], (BF16_PEAK, peaks[1]))
        by_name[f"seanet_resblock_packed_default_{dt_name}"].update({
            "status": "ported", "route": "cuda",
            "source": "audiocodecs_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "audiocodecs_tpu/ops/seanet_block_packed.py:123",
            "max_abs_err": worst, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["library_ms"],
            "shape": f"sum over (C, T) = (32, 240000), (64, 120000) at B=8, "
                     f"{dt_name} operands; no model calls it"})


def phase_seanet_tiers(torch, rows):
    """The EnCodec-style serving tier (``apply_serving_preset``: bf16
    decoder activations, one bf16 pass) of EnCodec-24k, PAST-16k, Mimi-24k
    and SpeechTokenizer-16k at B = 8 x 10 s, each beside its exact tier in
    the same call, as ``_tier``: tokens equal to the exact tier's bit for
    bit, the waveform's move off it, one row's first second decoded on the
    card against the CPU path of the same tier (rms no larger than the
    tier's move), and the two roundtrips. EnCodec-24k and PAST-16k launch
    4 exact B2 (encoder) and 4 one-pass bf16 B2 (decoder) and 4 LSTM a
    roundtrip; Mimi none; SpeechTokenizer 6 LSTM. EnCodec-24k's tier is
    profiled."""
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.models.mimi import Mimi
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.models.speechtokenizer import SpeechTokenizer
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    fused = _launch_table(4, 4, seanet_resblock_default_bf16=4)
    cases = (("encodec_24k", Encodec, "encodec", 24000, fused, 75),
             ("past_16k", PAST, "past", 16000, fused, 50),
             ("mimi_24k", Mimi, "mimi", 24000, _launch_table(0, 0), 13),
             ("speechtokenizer_16k", SpeechTokenizer, "speechtokenizer",
              16000, _launch_table(6, 0), 50))
    rng = np.random.default_rng(16)
    for name, cls, family, sr, want, frames in cases:
        kw = apply_serving_preset(family)
        exact = cls(sr, sr, num_codebooks=8, device="cuda",
                    generator=torch.Generator().manual_seed(0))
        state = {k: v.detach().cpu() for k, v in exact.state_dict().items()}
        tier = cls(sr, sr, num_codebooks=8, device="cuda", state_dict=state,
                   **kw)
        cpu = cls(sr, sr, num_codebooks=8, device="cpu", state_dict=state,
                  **kw)
        sig = _noise(rng, [(8, 10 * sr)])[0]
        res = _tier(torch, rows, f"{name}_balanced", exact, tier, cpu, sig,
                    want, "one pass", frames=frames, units=False)
        sig_dev = res.pop("sig_dev")
        if name == "encodec_24k":
            phase_profile(torch, lambda: tier.roundtrip(sig_dev),
                          res["roundtrip_ms"])
        del exact, tier, cpu, sig_dev


def phase_certify(torch, rows):
    """The reduced-precision encoder that ``quant/certify.py`` certifies:
    EnCodec-24k (seeded random weights, 8 codebooks) at B = 4 x 10 s with
    ``encode_precision="default"`` beside the exact encoder, through
    ``certify_codec`` (features and real tokens of both; each encode 2
    LSTM launches and 4 B2 launches, exact or one-pass fp32). Fails if a
    certified frame's real tokens differ from the exact path's. Prints the
    certified share, the real token match and both encodes' times."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    try:
        import certify_torch
    finally:
        sys.path.pop(0)
    from audiocodecs_tpu_torch.quant.certify import certify_codec

    exact = certify_torch.build("encodec", "cuda")
    fast = certify_torch.build("encodec", "cuda", encode_precision="default")
    sig = certify_torch.signal(CERTIFY_B, CERTIFY_SECONDS, 24000)
    reset_counts()
    with torch.inference_mode():
        res = certify_codec(exact, fast, sig)
    torch.cuda.synchronize()
    counts = read_counts()
    # two encodes a codec (features, then tokens)
    want = _launch_table(8, 8, seanet_resblock_default_f32=8)
    log(f"certify launches: {json.dumps(counts)}")
    if counts != want:
        fail(f"certify: expected launches {want}, got {counts}")
    _add_launches(rows, "certify_encodec_24k", counts)
    sig_dev = torch.as_tensor(sig, device="cuda")
    with torch.inference_mode():
        exact_ms = cuda_ms(torch, lambda: exact.sig_to_toks(sig_dev), reps=5)
        fast_ms = cuda_ms(torch, lambda: fast.sig_to_toks(sig_dev), reps=5)
    log(f"certify encodec_24k B={CERTIFY_B} x {CERTIFY_SECONDS} s, "
        f"encode_precision='default' against exact: {json.dumps(res)}; "
        f"encode (sig_to_toks) {fast_ms:.3f} ms one-pass against "
        f"{exact_ms:.3f} ms exact")
    if res["certified_but_real_mismatch"]:
        fail(f"certify: {res['certified_but_real_mismatch']} certified "
             "frames whose real tokens differ from the exact path's")
    if not 0.0 < res["max_delta"]:
        fail("certify: the one-pass encoder did not move the features")


# Slice 11: the zoo's first six families at their published widths
ZOO_SECONDS = 10.0
# the loading phases' (35, 36) long requests: 5 s rows, cut from 10 s to
# make room for phase 42 (the rows held against the CPU are unchanged)
LOADING_SECONDS = 5.0
# the zoo's codecs whose decoder the reference runs in conv_role("decoder"):
# path → the CPU twin (host memory only) of its phase's codec, whose weights
# phase_zoo_one_pass decodes with
ONE_PASS_ZOO = {}


def _zoo_requests(seed, sr, ragged):
    """Two B = 8 x 10 s requests and one ragged B = 1 request."""
    T = int(sr * ZOO_SECONDS)
    return _noise(np.random.default_rng(seed), [(8, T), (8, T), (1, ragged)])


def phase_audiodec(torch, rows):
    """AudioDec-24k (symAD: 32 → 512 channels over strides (3, 4, 5, 5),
    hop 300, 8 x 1024 x 64 RVQ): no kernel launch a roundtrip."""
    from audiocodecs_tpu_torch.models.audiodec import AudioDec
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop = 24000, 8, 300
    codec, cpu = _server_pair(torch, AudioDec, sr, sr, num_codebooks=K)

    def shapes(shape):  # every strided causal conv rounds up
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, K), (shape[0], N * hop)

    _batch_path(torch, rows, "audiodec_24k", codec, cpu,
                _zoo_requests(17, sr, 120001), _launch_table(0, 0), shapes,
                (lambda f: rvq_encode(f, codec.codebooks),
                 lambda t: rvq_decode(t, codec.codebooks), codec._decode))


def _encode_stream(torch, codec, sig, frames: int):
    """``sig`` [B, T] through ``encode_chunk`` in chunks of ``frames`` token
    frames, synced after each chunk → (tokens, ms a chunk by the host's
    clock)."""
    step = codec.frame_size * frames
    state = codec.init_streaming_state(sig.shape[0])
    toks, ms = [], []
    for pos in range(0, sig.shape[1], step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t, state = codec.encode_chunk(sig[:, pos:pos + step], state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(t)
    return torch.cat(toks, 1), ms


def phase_hilcodec(torch, rows):
    """HILCodec-24k (32 → 512 channels over strides (2, 4, 5, 8), hop 320,
    8 x 1024 x 128 RVQ, waveform skips): no kernel launch a roundtrip; then
    the first request streamed through ``encode_chunk`` in 80 ms chunks (6
    frames), no launch, its tokens against the card's batch encode, and the
    chunk times."""
    from audiocodecs_tpu_torch.models.hilcodec import HILCodec
    from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

    sr, K, hop, frames = 24000, 8, 320, 6
    codec, cpu = _server_pair(torch, HILCodec, sr, sr, num_codebooks=K)
    ONE_PASS_ZOO["hilcodec_24k"] = cpu  # decoded again in phase 29
    requests = _zoo_requests(18, sr, 120001)

    def shapes(shape):  # every strided causal conv rounds down
        N = shape[1] // hop
        return (shape[0], N, K), (shape[0], N * hop)

    path = "hilcodec_24k"
    none = _launch_table(0, 0)
    _batch_path(torch, rows, path, codec, cpu, requests, none, shapes,
                (lambda f: rvq_encode(f, codec.codebooks, K),
                 lambda t: rvq_decode(t, codec.codebooks),
                 lambda q: codec._feats_to_sig(q, None)))

    sig_dev = torch.as_tensor(requests[0], device="cuda")
    reset_counts()
    toks, _ = _encode_stream(torch, codec, sig_dev, frames)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{path} stream launches: {json.dumps(counts)}")
    if counts != none:
        fail(f"{path} stream: expected no launches, got {counts}")
    batch = codec.sig_to_toks(sig_dev)
    if tuple(toks.shape) != tuple(batch.shape):
        fail(f"{path} stream shapes: toks {tuple(toks.shape)}, batch "
             f"{tuple(batch.shape)}")
    mism = int((toks != batch).sum())
    match = 1.0 - mism / batch.numel()
    log(f"{path} stream against batch encode on the card: token_match="
        f"{match:.6f} ({mism} of {batch.numel()} differ)")
    if not match >= 0.999:
        fail(f"{path} stream: token_match {match} < 0.999")
    _, ms = _encode_stream(torch, codec, sig_dev, frames)
    srt = sorted(ms)
    p90 = srt[min(len(srt) - 1, math.ceil(0.9 * len(srt)) - 1)]
    log(f"{path} encode stream B={sig_dev.shape[0]} x {ZOO_SECONDS} s in "
        f"{len(ms)} chunks of {frames * hop / sr * 1e3:.0f} ms: chunk_ms "
        f"median={statistics.median(ms):.3f} p90={p90:.3f} max="
        f"{srt[-1]:.3f}; rtf_per_stream={ZOO_SECONDS / (sum(ms) / 1e3):.3f}")
    n = codec.frame_size * frames * 10
    phase_profile(torch,
                  lambda: _encode_stream(torch, codec, sig_dev[:, :n],
                                         frames),
                  statistics.median(ms) * 10, "10 chunks (10 x median)",
                  top=8)


def phase_nanocodec(torch, rows):
    """NanoCodec-22.05k (16 → 1024 channels over rates (2, 2, 3, 3, 7, 7),
    hop 1764, HiFiGAN res layers of kernels (3, 7, 11), half-snake, 4 FSQ
    groups of (8, 8, 8, 8)): no kernel launch a roundtrip."""
    from audiocodecs_tpu_torch.models.nanocodec import NanoCodec

    sr, K, hop = 22050, 4, 1764
    codec, cpu = _server_pair(torch, NanoCodec, sr, sr)

    def shapes(shape):  # every strided causal conv rounds up
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, K), (shape[0], N * hop)

    _batch_path(torch, rows, "nanocodec_22k", codec, cpu,
                _zoo_requests(19, sr, 110251), _launch_table(0, 0), shapes,
                (codec._quantize, codec._toks_to_codes,
                 lambda q: codec._feats_to_sig(q, None)))


def _xcodec2_frames(mc, n_samples: int) -> int:
    """Frames of both branches, the fewer: the acoustic encoder's strided
    convs (k = 2s, pad ⌈s/2⌉ a side) floor; w2v-BERT's 10 ms frames of the
    waveform padded by 160 a side, stacked in pairs."""
    acoustic = _bigcodec_frames(mc.encoder(), n_samples)
    mel = 1 + (n_samples + 320 - 400) // 160
    return min(acoustic, (mel + 1) // 2)


def phase_xcodec2(torch, rows):
    """X-Codec 2.0-16k (BigCodec's encoder at hop 320 with its 2 LSTM layers
    at H = 1536; w2v-BERT 2.0 to layer 16 of 24; FSQ (4,)x8; a 12-block
    RoFormer and an ISTFT head): two wide kernel-1 launches a roundtrip
    (one a layer, 8 rows a launch), nothing else; parity on the ragged
    request and one row of the first."""
    from audiocodecs_tpu_torch.models.xcodec2 import XCodec2

    sr = 16000
    codec, cpu = _server_pair(torch, XCodec2, sr, sr)
    ONE_PASS_ZOO["xcodec2_16k"] = cpu  # decoded again in phase 29
    mc = codec.model_config

    def shapes(shape):
        N = _xcodec2_frames(mc, shape[1])
        return (shape[0], N, 1), (shape[0], N * mc.hop_length)

    requests = _zoo_requests(20, sr, 80001)
    _batch_path(torch, rows, "xcodec2_16k", codec, cpu, requests,
                _launch_table(2, 0, wide=2), shapes,
                (lambda f: codec._quantize(f)[..., None],
                 lambda t: codec._toks_to_qfeats(t, None), codec._decode),
                parity_rows=1)
    _xcodec2_margin(torch, "xcodec2_16k", codec, cpu, requests[-1])


def _xcodec2_margin(torch, path, codec, cpu, sig):
    """``_fsq_margin`` of X-Codec 2.0's projected latents."""
    from audiocodecs_tpu_torch.nn.transformer import _linear

    _fsq_margin(torch, path, codec, cpu, sig,
                lambda c, x: _linear(c._sig_to_feats(x, None),
                                     c.quantizer.project_in),
                codec.model_config.levels)


def _margin(torch, path, codec, cpu, sig, what, values, distance):
    """How near the edges where a token flips the card's values fall on
    ``sig``: ``values(c, x)`` on the card's codec and on its CPU twin, and
    ``distance(v)`` of each value to its edge; the least distance (and the
    median) beside the largest card-CPU gap of the values. A token can
    differ only where the gap exceeds the distance."""
    def run(c):
        with torch.inference_mode():
            x = torch.as_tensor(sig, device=c.device)
            return values(c, x).cpu().double()

    v_card, v_cpu = run(codec), run(cpu)
    margin = distance(v_card)
    gap = float((v_card - v_cpu).abs().max())
    log(f"{path} {what} margin on {sig.shape}: least distance to the edge "
        f"{float(margin.min()):.3e} (median {float(margin.median()):.3e}); "
        f"{int((margin < gap).sum())} of {margin.numel()} values nearer "
        f"than the largest card-CPU gap {gap:.3e}")


def _fsq_margin(torch, path, codec, cpu, sig, latents, levels):
    """``_margin`` of an FSQ's bounded latents (``latents(c, x)``, on
    ``levels``) to their half-steps."""
    from audiocodecs_tpu_torch.quant.fsq import fsq_bound

    _margin(torch, path, codec, cpu, sig, "FSQ",
            lambda c, x: fsq_bound(latents(c, x), levels),
            lambda b: 0.5 - (b - torch.round(b)).abs())


def phase_stablecodec(torch, rows):
    """StableCodec-16k (patch 320, dim 1024, 8 + 8 RoFormer blocks a side,
    the residual FSQ (2, 15625)): no kernel launch a roundtrip."""
    from audiocodecs_tpu_torch.models.stablecodec import StableCodec

    sr, K, hop = 16000, 2, 640
    codec, cpu = _server_pair(torch, StableCodec, sr, sr)
    ONE_PASS_ZOO["stablecodec_16k"] = cpu  # decoded again in phase 29

    def shapes(shape):  # padded to whole 640-sample windows
        N = math.ceil(shape[1] / hop)
        return (shape[0], N, K), (shape[0], N * hop)

    _batch_path(torch, rows, "stablecodec_16k", codec, cpu,
                _zoo_requests(21, sr, 80001), _launch_table(0, 0), shapes,
                (lambda f: codec._residual_encode(f, K),
                 lambda t: codec._toks_to_qfeats(t, None), codec._decode))


def phase_magicodec(torch, rows):
    """MagiCodec-16k (patch conv k 640 / stride 320, dim 1024, 8 RoFormer
    blocks a side, one 131072 x 16 codebook on unit vectors): no kernel
    launch a roundtrip."""
    from audiocodecs_tpu_torch.models.magicodec import MagiCodec

    sr, hop = 16000, 320
    codec, cpu = _server_pair(torch, MagiCodec, sr, sr)
    ONE_PASS_ZOO["magicodec_16k"] = cpu  # decoded again in phase 29

    def shapes(shape):
        N = shape[1] // hop
        return (shape[0], N, 1), (shape[0], N * hop)

    _batch_path(torch, rows, "magicodec_16k", codec, cpu,
                _zoo_requests(22, sr, 80001), _launch_table(0, 0), shapes,
                (lambda f: codec._quantize(f)[..., None],
                 lambda t: codec._toks_to_qfeats(t, None), codec._decode))


# Slice 12: the WavLM-tower families at their published widths, and the
# zoo's decoders at one bf16 pass
def _wavlm_frames(cfg, n_samples: int) -> int:
    """Frames of the WavLM tower's conv feature extractor (valid convs)."""
    n = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


def _vocoder_tier(torch, rows, path, cls, family, exact, sig):
    """The balanced tier of a family with a SEANet vocoder (bf16 decoder
    activations: its non-causal blocks run cuDNN in bf16, no kernel) beside
    the exact tier, as in 21 (``_tier``)."""
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    kw = apply_serving_preset(family)
    sr = exact.sample_rate
    state = {k: v.detach().cpu() for k, v in exact.state_dict().items()}
    tier = cls(sr, sr, device="cuda", state_dict=state, **kw)
    cpu = cls(sr, sr, device="cpu", state_dict=state, **kw)
    _tier(torch, rows, f"{path}_balanced", exact, tier, cpu, sig,
          _launch_table(0, 0), "one pass", frames=50, units=False)
    del tier, cpu


def phase_wavlm_kmeans(torch, rows):
    """WavLM+K-means-16k (WavLM-large, 24 x 1024, its layer 6 quantized by
    512 centroids; the tower runs to layer 6; a SEANet vocoder of 32
    filters, non-causal): no kernel launch a roundtrip (B2 takes causal
    blocks only); parity on the ragged request and one row of the first;
    then its balanced tier (a bf16 vocoder) beside the exact one."""
    from audiocodecs_tpu_torch.models.wavlm_kmeans import WavLMKmeans
    from audiocodecs_tpu_torch.quant.vq import vq_encode

    sr = 16000
    codec, cpu = _server_pair(torch, WavLMKmeans, sr, sr)
    mc = codec.model_config

    def shapes(shape):
        N = _wavlm_frames(mc.wavlm, shape[1])
        return (shape[0], N, 1), (shape[0], N * 320)

    requests = _zoo_requests(23, sr, 80001)
    _batch_path(torch, rows, "wavlm_kmeans_16k", codec, cpu, requests,
                _launch_table(0, 0), shapes,
                (lambda f: vq_encode(f, codec.kmeans[0])[..., None],
                 lambda t: codec._toks_to_qfeats(t, None), codec._vocode),
                parity_rows=1)
    del cpu
    _vocoder_tier(torch, rows, "wavlm_kmeans_16k", WavLMKmeans,
                  "wavlm_kmeans", codec, requests[0])


def _segment_use(torch, path, codec, sig):
    """DyCAST's segments an utterance of ``sig`` and the frames of the last
    one, against the capacity and the duration token's clip."""
    mc = codec.model_config
    with torch.inference_mode():
        _, counts, segments = codec._segments(
            torch.as_tensor(sig, device="cuda"))
    log(f"{path} segments on {sig.shape}: {segments.tolist()} of capacity "
        f"{mc.max_segments}, the last {counts[:, -1].tolist()} frames "
        f"(duration token clipped to {mc.max_duration - 1})")


def phase_dycast(torch, rows):
    """DyCAST-16k (WavLM-base to layer 6; a boundary head, 128 segments of
    32 two-bit channels and a duration; a decode budget of 128 x 4 frames;
    the SEANet vocoder): no kernel launch a roundtrip; parity on the ragged
    request and one row of the first; the boundary margin; the decode of a
    random full grid (every segment, durations past the budget) against
    the CPU path; then its balanced tier (a bf16 vocoder) beside the exact
    one."""
    from audiocodecs_tpu_torch.models.dycast import DyCAST

    sr = 16000
    codec, cpu = _server_pair(torch, DyCAST, sr, sr)
    mc = codec.model_config
    S, K = mc.max_segments, mc.num_channels + 1

    def shapes(shape):  # the segment capacity, whatever the input
        return (shape[0], S, K), (shape[0], S * 4 * 320)

    requests = _zoo_requests(24, sr, 80001)
    _batch_path(torch, rows, "dycast_16k", codec, cpu, requests,
                _launch_table(0, 0), shapes, None, parity_rows=1)
    _dycast_margin(torch, "dycast_16k", codec, cpu, requests[-1])
    _segment_use(torch, "dycast_16k", codec, requests[-1])
    # a full grid: every segment valid, durations overrunning the budget
    rng = np.random.default_rng(28)
    grid = np.concatenate(
        [rng.integers(0, 4, (1, S, K - 1)),
         rng.integers(0, mc.max_duration, (1, S, 1))], axis=-1)
    y = codec.toks_to_sig(grid).cpu()
    y_cpu = cpu.toks_to_sig(grid)
    err, lim = float((y - y_cpu).abs().max()), 1e-4 * float(
        y_cpu.abs().max())
    log(f"dycast_16k full grid ({S} segments, {int(grid[..., -1].sum())} "
        f"frames of durations into a budget of {S * 4}): decode card vs "
        f"CPU max_abs_diff={err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        fail("dycast_16k: the full grid's decode disagrees with the CPU")
    del cpu
    _vocoder_tier(torch, rows, "dycast_16k", DyCAST, "dycast", codec,
                  requests[0])


def _dycast_margin(torch, path, codec, cpu, sig):
    """``_margin`` of DyCAST's boundary logits to their threshold."""
    from audiocodecs_tpu_torch.nn.wavlm import apply_wavlm

    mc = codec.model_config
    thr = mc.boundary_threshold
    _margin(torch, path, codec, cpu, sig, "boundary",
            lambda c, x: c._boundary_logits(apply_wavlm(
                c.wavlm, x, mc.wavlm, output_layer=mc.wavlm_layer)),
            lambda v: (v - thr).abs())


def _focal_margin(torch, path, codec, cpu, sig):
    """``_margin`` of FocalCodec's latents to the signs' edge, 0."""
    _margin(torch, path, codec, cpu, sig, "sign",
            lambda c, x: c._latents(x), torch.abs)


def phase_focalcodec(torch, rows):
    """FocalCodec-16k (6 layers of WavLM-large, a 2-block focal compressor
    to 13 sign bits, the decompressor and a Vocos head 512 x 8): no kernel
    launch a roundtrip; parity on the ragged request and one row of the
    first; the sign margin."""
    from audiocodecs_tpu_torch.models.focalcodec import FocalCodec, bsq_encode

    sr = 16000
    codec, cpu = _server_pair(torch, FocalCodec, sr, sr)
    mc = codec.model_config

    def shapes(shape):  # the ISTFT's "center" padding drops a hop
        N = _wavlm_frames(mc.wavlm, shape[1])
        return (shape[0], N, 1), (shape[0], (N - 1) * mc.hop_length)

    requests = _zoo_requests(25, sr, 80001)
    _batch_path(torch, rows, "focalcodec_16k", codec, cpu, requests,
                _launch_table(0, 0), shapes,
                (lambda f: bsq_encode(f)[..., None],
                 lambda t: codec._toks_to_qfeats(t, None),
                 codec._decode_latents), parity_rows=1)
    _focal_margin(torch, "focalcodec_16k", codec, cpu, requests[-1])


def phase_bicodec(torch, rows):
    """BiCodec-16k (wav2vec2-XLSR to hidden state 16 of 24, the ConvNeXt
    encoder and an 8192 x 8 cosine VQ; the mel, ECAPA, the perceiver and a
    4^6 FSQ for 32 global tokens; a 1536-channel WaveGenerator): six
    kernel-3 launches a roundtrip in the exact form (the generator's units
    at C = 192 and 96), the fused units packed on the first decode only;
    parity on the ragged request and one row of the first; how near the
    global tokens' FSQ half-steps the card's latents fall."""
    from audiocodecs_tpu_torch.models.bicodec import BiCodec
    from audiocodecs_tpu_torch.models.dac import ResidualUnit
    from audiocodecs_tpu_torch.ops.dac_resunit import pack_resunit_weights

    sr = 16000
    codec, cpu = _server_pair(torch, BiCodec, sr, sr)
    mc = codec.model_config
    G = mc.num_global_tokens
    fused = sum(u.fused for u in codec.decoder.modules()
                if isinstance(u, ResidualUnit))

    def shapes(shape):
        N = _wavlm_frames(mc.w2v, shape[1])
        return (shape[0], G + N, 1), (shape[0], N * 320)

    requests = _zoo_requests(26, sr, 80001)
    _batch_path(torch, rows, "bicodec_16k", codec, cpu, requests,
                _launch_table(0, 0, dac=fused), shapes, None, parity_rows=1,
                packs=(lambda: pack_resunit_weights.packs, fused))
    _bicodec_margin(torch, "bicodec_16k", codec, cpu, requests[-1])


def _bicodec_margin(torch, path, codec, cpu, sig):
    """``_fsq_margin`` of BiCodec's global latents."""
    _fsq_margin(torch, f"{path} global tokens", codec, cpu, sig,
                lambda c, x: c._global_latents(x),
                codec.model_config.fsq_levels)


SEMANTICODEC_SR = 16000
# max|decode − decode'| / max|sig| of two correct fp32 decodes of the 15 s
# request at 2 DDIM steps: float32 against float64 on the CPU
# (tools/semanticodec_fp32_gap.py on the H100 machine's host: 3.79e-6);
# the card is held to the larger of it and 1e-4
SEMANTICODEC_FP32_GAP = 3.79e-6


def semanticodec_requests():
    """SemantiCodec's two requests: B = 8 x 10 s (one window each) and
    B = 1 x 15 s (two windows), N(0, 0.1²) noise."""
    sr = SEMANTICODEC_SR
    return _noise(np.random.default_rng(29), [(8, 10 * sr), (1, 15 * sr)])


def _flops(torch, fn) -> float:
    """The products' and convs' FLOPs of one run of ``fn``
    (``torch.utils.flop_counter``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _semanticodec_stages(torch, codec, sig_dev, peaks):
    """Each stage of a roundtrip of ``sig_dev`` timed (CUDA events) and
    counted (FLOPs of its products and convs), with its bound at the fp32
    and the bf16 peak: the encode (fbank, AudioMAE, both VQs), one UNet
    call (the CFG pair of every window), the VAE decoder and the vocoder;
    and the roundtrip's FLOPs (the encode, ddim_steps UNet calls, the VAE
    and the vocoder)."""
    from audiocodecs_tpu_torch.nn.hifigan import apply_hifigan
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.ldm_unet import apply_unet
    from audiocodecs_tpu_torch.nn.ldm_vae import apply_vae_decoder

    mc = codec.model_config
    dt = codec._ldm_form.dtype
    with torch.inference_mode(), exact_fp32():
        toks = codec._sig_to_toks(sig_dev, None)
        cond = codec._toks_to_qfeats(toks, None).to(dt)
        B, N = cond.shape[:2]  # one window a row: padded to it with −1
        cond = torch.nn.functional.pad(
            cond, (0, 0, 0, mc.tokens_per_window - N), value=-1.0)
        gen = torch.Generator(device="cuda").manual_seed(5)
        ds = mc.vae_cfg.downsample_factor
        x = torch.randn((2 * B, mc.vae_cfg.embed_dim, mc.window_frames // ds,
                         mc.ldm_mel_bins // ds), device="cuda",
                        generator=gen)
        ctx2 = torch.cat([cond, torch.zeros_like(cond)])
        t = torch.full((2 * B,), 981.0, device="cuda")
        z = x[:B] / codec.latent_scale
        mel = apply_vae_decoder(codec.vae, z, mc.vae_cfg, dt)[:, 0]
        stages = {
            "encode": lambda: codec._sig_to_toks(sig_dev, None),
            "unet_step": lambda: apply_unet(codec.unet, x, t, ctx2,
                                            mc.unet(), dt),
            "vae": lambda: apply_vae_decoder(codec.vae, z, mc.vae_cfg, dt),
            "vocoder": lambda: apply_hifigan(codec.vocoder,
                                             mel.transpose(1, 2),
                                             mc.vocoder_cfg,
                                             codec._ldm_form),
        }
        out = {}
        for name, fn in stages.items():
            flops = _flops(torch, fn)
            ms = cuda_ms(torch, fn, reps=3, warmup=1)
            out[name] = {"ms": ms, "gflop": flops / 1e9,
                         "bound_fp32_ms": flops / peaks[0] * 1e3,
                         "bound_bf16_ms": flops / BF16_PEAK * 1e3}
    total = (out["encode"]["gflop"] + mc.ddim_steps * out["unet_step"][
        "gflop"] + out["vae"]["gflop"] + out["vocoder"]["gflop"]) * 1e9
    return out, total


def phase_semanticodec(torch, rows):
    """SemantiCodec-16k at its published widths (AudioMAE ViT-B, two 8192
    codebooks at 50 Hz, the LDM UNet 128 x (1, 2, 3, 5) with context 1536,
    the VAE and the 1024-channel HiFi-GAN, 50 DDIM steps with guidance
    2.0): B = 8 x 10 s and B = 1 x 15 s (two windows: the crossfade on the
    card); no kernel launch; shapes, finite, tokens below their vocab, the
    decode deterministic; parity against the CPU path (tokens, features,
    one UNet call at t = 981, the 15 s request's decode at 2 steps); the
    warm roundtrip, stages and bounds, the profile (at 5 DDIM steps); the
    balanced tier
    (bf16 UNet, VAE and vocoder) beside it; then WavLM+K-means with its
    HiFi-GAN vocoder against the CPU.

    The bf16 tier's check: each bf16 product is rounded right on both
    devices, but a rounding flip anywhere (another summation order, even
    another batch on the same card) spreads into fresh flips over every
    fan-out, so two bf16 decodes are independent draws of the tier's
    rounding error: the card is held within √2 of the tier's move of the
    CPU, and the card against itself in another batch is logged beside."""
    import dataclasses

    from audiocodecs_tpu_torch.models.semanticodec import SemantiCodec
    from audiocodecs_tpu_torch.models.wavlm_kmeans import WavLMKmeans
    from audiocodecs_tpu_torch.nn.layers import exact_fp32
    from audiocodecs_tpu_torch.nn.ldm_unet import apply_unet
    from audiocodecs_tpu_torch.serving import apply_serving_preset

    sr, path = SEMANTICODEC_SR, "semanticodec_16k"
    t_phase = time.perf_counter()

    def elapsed(what):
        log(f"{path}: {what} after {time.perf_counter() - t_phase:.1f} s")

    peaks = _PEAKS["pcie" if "PCIe" in torch.cuda.get_device_name(0)
                   else "sxm"]
    codec, cpu = _server_pair(torch, SemantiCodec, sr, sr)
    state = {k: v.detach().cpu() for k, v in codec.state_dict().items()}
    mc = codec.model_config
    hop = mc.window_frames // mc.tokens_per_window * mc.mel_hop
    requests = semanticodec_requests()

    def shapes(shape):
        cols = shape[1] // (mc.patch_size * mc.mel_hop) + 1
        N = -(-mc.freq_patches * cols // mc.stack_factor)
        return (shape[0], N, 2), (shape[0], N * hop)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    answers = [(toks, codec.toks_to_sig(toks)) for toks in
               (codec.sig_to_toks(sig) for sig in requests)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    log(f"{path} launches over {len(requests)} roundtrips: "
        f"{json.dumps(counts)}")
    if counts != _launch_table(0, 0):
        fail(f"{path}: expected no kernel launches, got {counts}")
    _add_launches(rows, path, counts)
    vocab = torch.tensor(codec.config.vocab_sizes, device="cuda")
    for sig, (toks, y) in zip(requests, answers):
        if (tuple(toks.shape), tuple(y.shape)) != shapes(sig.shape):
            fail(f"{path} shapes: toks {tuple(toks.shape)}, sig "
                 f"{tuple(y.shape)} for {sig.shape}; want "
                 f"{shapes(sig.shape)}")
        if not bool(torch.isfinite(y).all()) or not bool(
                ((toks >= 0) & (toks < vocab)).all()):
            fail(f"{path}: non-finite waveform or tokens out of vocab")
        log(f"{path} {sig.shape}: decode max|sig|="
            f"{float(y.abs().max()):.4e} rms={_rms(y):.4e}, "
            f"{float((y.abs() > 0.999).float().mean()):.4f} of the samples "
            f"tanh-saturated (|y| > 0.999)")
    if not torch.equal(codec.toks_to_sig(answers[1][0]), answers[1][1]):
        fail(f"{path}: two decodes of the same tokens differ")
    elapsed("requests and determinism")

    # parity against the CPU path on the same weights
    t0 = time.perf_counter()
    for i, sig in enumerate(requests):
        f_gpu = codec.sig_to_feats(sig).cpu()
        f_cpu = cpu.sig_to_feats(sig)
        with torch.inference_mode():
            t_cpu = cpu._feats_to_toks(f_cpu)
        mism = int((answers[i][0].cpu() != t_cpu).sum())
        match = 1.0 - mism / t_cpu.numel()
        f_err = float((f_gpu - f_cpu).abs().max())
        f_lim = 1e-4 * float(f_cpu.abs().max())
        log(f"{path} request {i} {sig.shape}: feats max_abs_diff="
            f"{f_err:.3e} (limit {f_lim:.3e}); token_match={match:.6f} "
            f"({mism} of {t_cpu.numel()} differ)")
        if not f_err <= f_lim or not match >= 0.999:
            fail(f"{path}: request {i} disagrees with the CPU path")
    ucfg = mc.unet()
    with torch.inference_mode():
        q = codec.toks_to_qfeats(answers[0][0][:1])
        ctx2 = torch.cat([q, torch.zeros_like(q)])
        ds = mc.vae_cfg.downsample_factor
        x = torch.randn((1, mc.vae_cfg.embed_dim, mc.window_frames // ds,
                         mc.ldm_mel_bins // ds),
                        generator=torch.Generator().manual_seed(7))
        x2 = torch.cat([x, x])
        t = torch.full((2,), 981.0)
        with exact_fp32():
            eps = apply_unet(codec.unet, x2.cuda(), t.cuda(), ctx2, ucfg)
            eps_cpu = apply_unet(cpu.unet, x2, t, ctx2.cpu(), ucfg)
    u_err = float((eps.cpu() - eps_cpu).abs().max())
    u_lim = 1e-4 * float(eps_cpu.abs().max())
    log(f"{path} one UNet call (B = 2, the CFG pair, t = 981): "
        f"max_abs_diff={u_err:.3e} (limit {u_lim:.3e})")
    if not u_err <= u_lim:
        fail(f"{path}: the UNet call disagrees with the CPU path")
    steps = 2
    twins = [SemantiCodec(sr, sr, mode="decode", device=d,
                          state_dict=state, ddim_sample_step=steps)
             for d in ("cuda", "cpu")]
    toks1 = answers[1][0]
    y2 = twins[0].toks_to_sig(toks1).cpu()
    t1 = time.perf_counter()
    y2_cpu = twins[1].toks_to_sig(toks1.cpu())
    dec_s = time.perf_counter() - t1
    scale = float(y2_cpu.abs().max())
    d_err = float((y2 - y2_cpu).abs().max())
    d_lim = max(1e-4, SEMANTICODEC_FP32_GAP) * scale
    log(f"{path} 15 s decode at {steps} DDIM steps (two windows): card vs "
        f"CPU max_abs_diff={d_err:.3e} ({d_err / scale:.3e} of max|sig| "
        f"{scale:.4e}; limit {d_lim:.3e}, the fp32 gap "
        f"{SEMANTICODEC_FP32_GAP:.1e}), rms={_rms(y2 - y2_cpu):.3e}; "
        f"cpu decode seconds={dec_s:.1f}; parity cpu seconds="
        f"{time.perf_counter() - t0:.1f}")
    if not d_err <= d_lim:
        fail(f"{path}: the 2-step decode disagrees with the CPU path")
    del cpu, twins[1]
    elapsed("CPU parity")

    # the warm roundtrip, stages and bounds
    sig = requests[0]
    B, seconds = sig.shape[0], sig.shape[1] / sr
    sig_dev = torch.as_tensor(sig, device="cuda")
    again = []  # the timed roundtrip's output: B = 8 decoded twice
    rt_ms = cuda_ms(torch, lambda: again.append(codec.roundtrip(sig_dev)),
                    reps=1, warmup=0)
    if not torch.equal(again[0], answers[0][1]):
        fail(f"{path}: two roundtrips of the B = 8 request differ")
    stages, flops = _semanticodec_stages(torch, codec, sig_dev, peaks)
    log(f"{path} roundtrip B={B} x {seconds} s ({mc.ddim_steps} DDIM "
        f"steps): {rt_ms:.3f} ms warm; rtf_per_stream="
        f"{seconds / (rt_ms / 1e3):.4f} rtf_aggregate="
        f"{B * seconds / (rt_ms / 1e3):.4f}; peak_mem_bytes={peak} (the "
        f"two requests); "
        f"{flops / 1e12:.3f} TFLOP of products and convs: bound "
        f"{flops / peaks[0] * 1e3:.1f} ms at the fp32 peak, "
        f"{flops / BF16_PEAK * 1e3:.1f} ms at the bf16 peak")
    log(f"{path} stages (B = {B}): " + json.dumps(
        {k: {n: round(v, 3) for n, v in d.items()}
         for k, d in stages.items()}))
    elapsed("timing")
    # the profile of a roundtrip at 5 DDIM steps on the same weights: at 50
    # (123,059 launches) the profiler's bookkeeping took 94 s on the host
    few = SemantiCodec(sr, sr, device="cuda", state_dict=state,
                       ddim_sample_step=5)
    few_ms = cuda_ms(torch, lambda: few.roundtrip(sig_dev), reps=1)
    phase_profile(torch, lambda: few.roundtrip(sig_dev), few_ms,
                  what="roundtrip at 5 DDIM steps")
    del few
    elapsed("profile")

    # the balanced tier: bf16 UNet, VAE and vocoder
    kw = apply_serving_preset("semanticodec")
    tier = SemantiCodec(sr, sr, device="cuda", state_dict=state, **kw)
    reset_counts()
    for sig_i, (toks, _) in zip(requests, answers):
        if not torch.equal(tier.sig_to_toks(sig_i), toks):
            fail(f"{path}_balanced: tokens differ from the exact tier's")
    y_tier = tier.toks_to_sig(answers[0][0])
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != _launch_table(0, 0):
        fail(f"{path}_balanced: expected no kernel launches, got {counts}")
    _add_launches(rows, f"{path}_balanced", counts)
    y_ex = answers[0][1]
    if y_tier.dtype != torch.float32 or not bool(
            torch.isfinite(y_tier).all()):
        fail(f"{path}_balanced: waveform {y_tier.dtype}, or not finite")
    move50 = _rms(y_tier - y_ex)
    tier2 = [SemantiCodec(sr, sr, mode="decode", device=d,
                          state_dict=state, ddim_sample_step=steps, **kw)
             for d in ("cuda", "cpu")]
    part = answers[0][0][:1]
    y2_tier = tier2[0].toks_to_sig(part)
    move2 = _rms(y2_tier - twins[0].toks_to_sig(part))
    # the control: the same row decoded on the card inside a batch of two
    # (other summation orders in a few products)
    batch = _rms(tier2[0].toks_to_sig(answers[0][0][:2])[:1] - y2_tier)
    t1 = time.perf_counter()
    y2_tier_cpu = tier2[1].toks_to_sig(part.cpu())
    got = _rms(y2_tier.cpu() - y2_tier_cpu)
    tier_ms = cuda_ms(torch, lambda: tier.roundtrip(sig_dev), reps=1,
                      warmup=0)
    t_stages, _ = _semanticodec_stages(torch, tier, sig_dev, peaks)
    log(f"{path}_balanced B={B} x {seconds} s: roundtrip {tier_ms:.3f} ms "
        f"warm (exact tier {rt_ms:.3f} ms, ratio {tier_ms / rt_ms:.3f}); "
        f"tokens equal to the exact tier's; off the exact tier at "
        f"{mc.ddim_steps} steps rms={move50:.3e} max="
        f"{float((y_tier - y_ex).abs().max()):.3e}, at {steps} steps (one "
        f"row) rms={move2:.3e}; card vs CPU (same tier, {steps} steps) "
        f"rms={got:.3e} ({got / move2:.3f} of the move; limit "
        f"{math.sqrt(2) * move2:.3e}, two independent draws of it); the "
        f"card against itself, the row inside a batch of two, rms="
        f"{batch:.3e} ({batch / move2:.3f} of the move); cpu_seconds="
        f"{time.perf_counter() - t1:.1f}")
    log(f"{path}_balanced stages (B = {B}): " + json.dumps(
        {k: {n: round(v, 3) for n, v in d.items()}
         for k, d in t_stages.items()}))
    if not 0.0 < move2 or not got <= math.sqrt(2) * move2:
        fail(f"{path}_balanced: the tier moved the decode by {move2}, the "
             f"card is {got} off the CPU path")
    del tier, tier2, twins, codec
    elapsed("balanced tier")

    # WavLM+K-means with its HiFi-GAN vocoder (exact in every tier)
    wcfg = dataclasses.replace(WavLMKmeans.default_model_config(),
                               vocoder_variant="hifigan")
    wk, wk_cpu = _server_pair(torch, WavLMKmeans, sr, sr, model_config=wcfg)
    sig = requests[0][:1]
    reset_counts()
    toks = wk.sig_to_toks(sig)
    y = wk.toks_to_sig(toks)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != _launch_table(0, 0):
        fail(f"wavlm_kmeans_hifigan_16k: expected no kernel launches, got "
             f"{counts}")
    _add_launches(rows, "wavlm_kmeans_hifigan_16k", counts)
    N = _wavlm_frames(wcfg.wavlm, sig.shape[1])
    if tuple(y.shape) != (1, N * 320) or not bool(torch.isfinite(y).all()):
        fail(f"wavlm_kmeans_hifigan_16k: waveform {tuple(y.shape)}, want "
             f"(1, {N * 320}), or not finite")
    log(f"wavlm_kmeans_hifigan_16k decode max|sig|={float(y.abs().max()):.4e}"
        f" rms={_rms(y):.4e}")
    _parity("wavlm_kmeans_hifigan_16k B=1 x 10 s", wk, wk_cpu, sig, toks, y)


def phase_zoo_one_pass(torch, rows):
    """The zoo's decoders that the reference runs inside
    ``conv_role("decoder")`` at fp32 activations and one bf16 pass
    (``decode_precision="default"``, its ``ACX_DEC_CONV_PRECISION=
    default``): HILCodec-24k, StableCodec-16k, X-Codec 2.0-16k and
    MagiCodec-16k, on the weights of their phases (24, 26-28), each decode
    one B = 1 x 10 s grid of seeded random tokens in the form on the card
    and on the CPU, and exactly on the card; no kernel launch; the form's
    move off the exact decode (rms) above 0, the card within it of the CPU
    path, as the one-pass tiers in 17; both decodes timed."""
    cases = (("hilcodec_24k", 8, 1024, 750),
             ("stablecodec_16k", 2, 15625, 250),
             ("xcodec2_16k", 1, 65536, 500),
             ("magicodec_16k", 1, 131072, 500))
    rng = np.random.default_rng(27)
    for path, K, C, N in cases:
        twin = ONE_PASS_ZOO.pop(path)
        cls, sr = type(twin), twin.sample_rate
        kw = {"mode": "decode", "num_codebooks": K,
              "state_dict": twin.state_dict()}
        exact = cls(sr, sr, device="cuda", **kw)
        one = cls(sr, sr, device="cuda", decode_precision="default", **kw)
        cpu = cls(sr, sr, device="cpu", decode_precision="default", **kw)
        toks = torch.as_tensor(rng.integers(0, C, (1, N, K)), device="cuda")
        reset_counts()
        y, y_exact = one.toks_to_sig(toks), exact.toks_to_sig(toks)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != _launch_table(0, 0):
            fail(f"{path} one pass: expected no launches, got {counts}")
        t0 = time.perf_counter()
        y_cpu = cpu.toks_to_sig(toks.cpu())
        cpu_s = time.perf_counter() - t0
        if not bool(torch.isfinite(y).all()):
            fail(f"{path} one pass: non-finite waveform")
        move, got = _rms(y - y_exact), _rms(y.cpu() - y_cpu)
        ms = cuda_ms(torch, lambda: one.toks_to_sig(toks), reps=5)
        ms_exact = cuda_ms(torch, lambda: exact.toks_to_sig(toks), reps=5)
        log(f"{path} one-pass decode B=1 x 10 s: {ms:.3f} ms warm (exact "
            f"{ms_exact:.3f} ms); off the exact decode rms={move:.3e} max="
            f"{float((y - y_exact).abs().max()):.3e} (max|sig| "
            f"{float(y_exact.abs().max()):.3f}); card vs CPU (same form) "
            f"rms={got:.3e} (limit {move:.3e}), max="
            f"{float((y.cpu() - y_cpu).abs().max()):.3e}; "
            f"cpu_seconds={cpu_s:.1f}")
        if not 0.0 < move or not got <= move:
            fail(f"{path} one pass: the form moved the decode by {move}, "
                 f"the card is {got} off the CPU path")
        del exact, twin, one, cpu



def _loading_families(phase: int):
    """(path, registry name, model config, schema, converter, constructor
    keywords, the requests as the family's phase sends them, launches a
    roundtrip, shapes, the rows of the first request held against the CPU
    path as the family's phase holds them, the token margin printed after
    them or None) of each family the loading phase ``phase`` drives at
    its batch path: 35's five, 36's two kernel-carrying families of the
    rest of the zoo."""
    if phase == 36:
        return _zoo_kernel_families()
    from audiocodecs_tpu_torch.convert.dac import (
        convert_dac_state_dict, dac_schema)
    from audiocodecs_tpu_torch.convert.encodec import (
        convert_encodec_state_dict, encodec_schema)
    from audiocodecs_tpu_torch.convert.zoo import (
        bigcodec_schema, convert_bigcodec_state_dict,
        convert_past_state_dict, convert_speechtokenizer_state_dict,
        past_schema, speechtokenizer_schema)
    from audiocodecs_tpu_torch.models.bigcodec import BigCodecModelConfig
    from audiocodecs_tpu_torch.models.dac import DAC
    from audiocodecs_tpu_torch.models.encodec import EncodecModelConfig
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.models.speechtokenizer import (
        SpeechTokenizerModelConfig)

    s16, s24, s44 = 16000, 24000, 44100
    sec = LOADING_SECONDS
    eight = [(8, int(sec * s16)), (1, 80001)]
    big = BigCodecModelConfig()
    return (
        ("encodec_24k", "encodec", EncodecModelConfig(), encodec_schema,
         convert_encodec_state_dict, {"num_codebooks": 8},
         [(8, int(sec * s24)), (1, 79201)], _launch_table(4, 8),
         _hop_shapes(320, 8), 8, None),
        ("dac_44k", "dac", DAC.default_model_config(s44), dac_schema,
         convert_dac_state_dict, {"num_codebooks": 9},
         [(1, int(sec * s44)), (2, 100001)], _launch_table(0, 0, dac=6),
         _hop_shapes(512, 9, math.floor), 1, None),
        ("speechtokenizer_16k", "speechtokenizer",
         SpeechTokenizerModelConfig(), speechtokenizer_schema,
         convert_speechtokenizer_state_dict, {"num_codebooks": 8}, eight,
         _launch_table(6, 0), _hop_shapes(320, 8), 2, None),
        ("past_16k", "past", PAST.default_model_config(), past_schema,
         convert_past_state_dict, {"num_codebooks": 8}, eight,
         _launch_table(4, 8), _hop_shapes(320, 8), 2, None),
        ("bigcodec_16k", "bigcodec", big, bigcodec_schema,
         convert_bigcodec_state_dict, {"latent": False}, eight,
         _launch_table(4, 0, dac=9, wide=4), _bigcodec_shapes(big), 2,
         None),
    )


def _zoo_kernel_families():
    """X-Codec 2.0-16k (B1 wide 2 a roundtrip) and BiCodec-16k (B4 6), as
    their phases 20 and 25 send them but at ``LOADING_SECONDS``: two
    B = 8 requests and a ragged one, its rows and one row of the first
    against the CPU path.
    BiCodec's checkpoint is two files, its own and the XLSR tower's."""
    from audiocodecs_tpu_torch.convert.zoo import (
        bicodec_schema, convert_bicodec_state_dict,
        convert_xcodec2_state_dict, wavlm_schema, xcodec2_schema)
    from audiocodecs_tpu_torch.models.bicodec import BiCodecModelConfig
    from audiocodecs_tpu_torch.models.xcodec2 import XCodec2ModelConfig

    T = int(16000 * LOADING_SECONDS)
    zoo = [(8, T), (8, T), (1, 80001)]
    xc, bc = XCodec2ModelConfig(), BiCodecModelConfig()

    def xcodec2_shapes(shape):
        N = _xcodec2_frames(xc, shape[1])
        return (shape[0], N, 1), (shape[0], N * xc.hop_length)

    def bicodec_shapes(shape):
        N = _wavlm_frames(bc.w2v, shape[1])
        return (shape[0], bc.num_global_tokens + N, 1), (shape[0], N * 320)

    return (
        ("xcodec2_16k", "xcodec2", xc, xcodec2_schema,
         convert_xcodec2_state_dict, {}, zoo, _launch_table(2, 0, wide=2),
         xcodec2_shapes, 1, _xcodec2_margin),
        ("bicodec_16k", "bicodec", bc,
         lambda mc: {"bicodec": bicodec_schema(mc),
                     "w2v": wavlm_schema(mc.w2v)},
         lambda ck, mc: convert_bicodec_state_dict(ck["bicodec"], mc,
                                                   w2v_sd=ck["w2v"]),
         {}, zoo, _launch_table(0, 0, dac=6), bicodec_shapes, 1,
         _bicodec_margin),
    )


# a residual unit's closing conv: the 1x1 of a DAC-style stack (DAC's
# ``res_unit<j>.conv2.weight``, BigCodec's and BiCodec's
# ``block.<j>.block.3.weight_g``), and NanoCodec's HiFi-GAN units'
# ``skip_conv`` (its gain ``skip_conv.conv.weight_g``)
_CLOSING = re.compile(r"res_unit\d\.conv2\.weight$|"
                      r"\.block\.\d+\.block\.3\.weight_g$|"
                      r"\.skip_conv\.conv\.weight_g$")


def _synth_checkpoint(spec: dict, seed: int, closing: float = 0.1) -> dict:
    """A seeded upstream-layout checkpoint for a family's schema ``spec``
    (``synth_state_dict``; a checkpoint of several files, BigCodec's or
    BiCodec's, a dict of their state dicts), each DAC-style residual
    unit's closing conv (``_CLOSING``) multiplied by ``closing``:
    a tenth, as the random-init phases draw it, keeps the residual stack
    near unit scale (at unit gain each residual add doubles the
    activations' variance, and the decoder's tanh saturates)."""
    from audiocodecs_tpu_torch.convert.torch_utils import synth_state_dict

    def draw(schema, s):
        sd = synth_state_dict(schema, s)
        for key, a in sd.items():
            if _CLOSING.search(key):
                a *= np.float32(closing)
        return sd

    if all(isinstance(s, dict) for s in spec.values()):
        return {part: draw(s, 100 * seed + i)
                for i, (part, s) in enumerate(spec.items())}
    return draw(spec, seed)


# the loading phases' checkpoints (path → (seed, done, box)), drawn on a
# host thread from the script's start (``prefetch_checkpoints``) while
# the kernels build and the early phases run
_DRAWS = {}


def _loading_draws():
    """(path, schema, seed) of every checkpoint phases 35 and 36 draw, in
    the order and with the seeds they draw them."""
    plan = [(f[0], f[3](f[2])) for f in _loading_families(35)]
    plan += [(f[0], f[3](f[2])) for f in _loading_families(36)]
    plan += [(f[0], f[4](f[2])) for f in _zoo_loading()]
    return [(path, spec, seed) for seed, (path, spec) in enumerate(plan)]


def prefetch_checkpoints() -> None:
    """Draw the loading phases' checkpoints (``_synth_checkpoint``: 3.6 G
    parameters, 14 GB of host memory, a minute of one core) on a daemon
    thread; numpy's generators release the GIL as they fill an array.
    ``_checkpoint`` takes each draw, waiting for it if it is not ready."""
    plan = _loading_draws()
    for path, _, seed in plan:
        _DRAWS[path] = (seed, threading.Event(), [])

    def work():
        for path, spec, seed in plan:
            _, done, box = _DRAWS[path]
            try:
                box.append(_synth_checkpoint(spec, seed))
            finally:
                done.set()

    threading.Thread(target=work, name="draw checkpoints",
                     daemon=True).start()


def _checkpoint(path: str, spec: dict, seed: int) -> dict:
    """``_synth_checkpoint(spec, seed)``, from the prefetch where it drew
    it."""
    seed_drawn, done, box = _DRAWS.pop(path, (None, None, None))
    if seed_drawn == seed:
        done.wait()
        if box:
            return box.pop()
    return _synth_checkpoint(spec, seed)


def _dac_unit_gain(torch, mc, convert, spec, seed, sig):
    """DAC-44.1k on the loading phase's draw at unit gain (the closing 1x1s
    not cut to a tenth), where the decode of the same tokens parts from
    the CPU path's by more than 1e-4 of max|sig|: is that B4 going wrong
    at large activations, or fp32 conditioning? The first 87 token
    frames (1 s) of ``sig``'s first row decoded on the card (six B4 launches),
    on the card with the units unfused (the plain unit on cuDNN, no
    launch) and on the CPU path; then each fused unit on the card fed the
    CPU unit's own input, against the CPU unit's output within 1e-4 of
    its max|out| (fails otherwise), and both against the unit in float64
    on the CPU."""
    from audiocodecs_tpu_torch.models.dac import (
        DAC, ResidualUnit, residual_unit_io)
    from audiocodecs_tpu_torch.ops.dac_resunit import (
        dac_resunit_reference, snake)

    sr, frames = mc.sampling_rate, 87
    state = convert(_synth_checkpoint(spec, seed, closing=1.0), mc)
    kw = {"model_config": mc, "state_dict": state, "num_codebooks": 9}
    codec = DAC(sr, sr, device="cuda", **kw)
    cpu = DAC(sr, sr, device="cpu", **kw)
    del state
    toks = codec.sig_to_toks(sig[:1])[:, :frames]
    reset_counts()
    y_card = codec.toks_to_sig(toks).cpu()
    if read_counts()["dac_resunit"] != 6:
        fail(f"dac_44k unit gain: expected 6 B4 launches, got "
             f"{read_counts()}")
    fused = [m for m in codec.decoder.modules()
             if isinstance(m, ResidualUnit) and m.fused]
    for m in fused:
        m.fused = False
    reset_counts()
    y_plain = codec.toks_to_sig(toks).cpu()
    launched = read_counts()["dac_resunit"]
    for m in fused:
        m.fused = True
    if launched:
        fail(f"dac_44k unit gain: the unfused decode launched B4 {launched}"
             f" times")
    dec, last = cpu.decoder, {}
    hook = dec.blocks[-1].register_forward_hook(
        lambda mod, args, out: last.setdefault("h", out.detach()))
    try:
        with residual_unit_io(dec) as (ins, outs):
            y_cpu = cpu.toks_to_sig(toks.cpu())
    finally:
        hook.remove()
    with torch.inference_mode():
        pre = torch.nn.functional.conv1d(
            snake(last["h"], dec.alpha_out), dec.conv_out.w,
            dec.conv_out.b, padding=3)
    scale = float(y_cpu.abs().max())
    e_card = float((y_card - y_cpu).abs().max())
    e_plain = float((y_plain - y_cpu).abs().max())
    e_same = float((y_card - y_plain).abs().max())
    log(f"dac_44k unit gain, {frames} frames: max|pre-tanh|="
        f"{float(pre.abs().max()):.3e} (rms {_rms(pre):.3e}), "
        f"{float((y_cpu.abs() > 0.99).float().mean()):.3f} of the samples "
        f"above 0.99; decode max_abs_diff against the CPU path: card "
        f"(B4) {e_card:.3e}, card with the units unfused (no kernel) "
        f"{e_plain:.3e} (1e-4 of max|sig| is {1e-4 * scale:.3e}); card "
        f"B4 against card unfused {e_same:.3e}")

    card_units = dict(codec.decoder.named_modules())
    worst = {"card": 0.0, "card_f64": 0.0, "cpu_f64": 0.0}
    with torch.inference_mode():
        for name, x in ins.items():
            if not card_units[name].fused:
                continue
            u = dict(dec.named_modules())[name]
            got = card_units[name](x.to("cuda")).cpu()
            want = outs[name]
            exact = dac_resunit_reference(
                *(t.double() for t in (x, u.conv1.w, u.conv1.b, u.alpha1,
                                       u.conv2.w, u.conv2.b, u.alpha2)),
                u.dilation)
            top = float(exact.abs().max())
            for key, a, b in (("card", got, want), ("card_f64", got, exact),
                              ("cpu_f64", want, exact)):
                worst[key] = max(worst[key], float(
                    (a.double() - b.double()).abs().max()) / top)
    log(f"dac_44k unit gain: {len(fused)} fused units fed the CPU path's "
        f"input, max|diff| / max|out|: card against the CPU unit "
        f"{worst['card']:.3e} (limit 1e-4), card against float64 "
        f"{worst['card_f64']:.3e}, CPU against float64 "
        f"{worst['cpu_f64']:.3e}")
    if not worst["card"] <= 1e-4:
        fail(f"dac_44k unit gain: B4 off its plain unit by {worst['card']}"
             f" of max|out|")
    del codec, cpu


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _load_timed(torch, cls, mc, state, kw, device="cuda"):
    """``cls`` at ``mc`` on ``state``, and the ms its construction took
    (the copy to the card included)."""
    sr = mc.sampling_rate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codec = cls(sr, sr, model_config=mc, state_dict=state, device=device,
                **kw)
    torch.cuda.synchronize()
    return codec, (time.perf_counter() - t0) * 1e3


def _drive_loaded_families(torch, rows, phase: int, seed0: int):
    """Each family of ``_loading_families(phase)`` on a seeded
    upstream-layout checkpoint (``_synth_checkpoint``), converted on the
    host (timed), loaded on the card through the registry's class with
    ``state_dict=`` (timed), its requests through ``_batch_path`` against
    the CPU path on the same converted weights, its token margin where it
    has one. DAC-44.1k also at unit gain (``_dac_unit_gain``)."""
    from audiocodecs_tpu_torch.models import get_codec_class

    card = _card_line()
    rng = np.random.default_rng(phase)
    for seed, (path, name, mc, schema, convert, kw, req_shapes, per_rt,
               shapes, parity_rows, margin) in enumerate(
                   _loading_families(phase), seed0):
        spec = schema(mc)
        ckpt = _checkpoint(path, spec, seed)
        t0 = time.perf_counter()
        state = convert(ckpt, mc)
        convert_ms = (time.perf_counter() - t0) * 1e3
        del ckpt
        cls = get_codec_class(name)
        codec, load_ms = _load_timed(torch, cls, mc, state, kw)
        cpu = cls(mc.sampling_rate, mc.sampling_rate, model_config=mc,
                  state_dict=state, device="cpu", **kw)
        del state
        requests = _noise(rng, req_shapes)
        rt_ms = _batch_path(torch, rows, f"{path}_loaded", codec, cpu,
                            requests, per_rt, shapes, None,
                            parity_rows=parity_rows)
        if margin is not None:
            margin(torch, f"{path}_loaded", codec, cpu, requests[-1])
        log(f"{path} loaded: convert_ms={convert_ms:.1f} load_ms="
            f"{load_ms:.1f} roundtrip_ms={rt_ms:.3f} (B="
            f"{requests[0].shape[0]} x "
            f"{requests[0].shape[1] / mc.sampling_rate:g} s, warm); card: "
            f"{card}")
        del codec, cpu
        torch.cuda.empty_cache()
        if name == "dac":
            _dac_unit_gain(torch, mc, convert, spec, seed, requests[-1])
            torch.cuda.empty_cache()


def phase_checkpoint_loading(torch, rows):
    """35. EnCodec-24k, DAC-44.1k, SpeechTokenizer-16k, PAST-16k and
    BigCodec-16k at their published widths on weights converted from an
    upstream-layout checkpoint: a state dict in the layout of the
    family's released checkpoint (``transformers``' for EnCodec and DAC,
    the vendor's for the others), drawn from the port's schema by a
    seeded generator (``_synth_checkpoint``: weight-norm gains and snake α
    in [0.5, 1.5], each DAC-style residual unit's closing 1×1 at a tenth,
    as the random-init phases draw it), converted on the host (timed),
    loaded on the card through the registry's class with ``state_dict=``
    (timed); then the family's two request shapes of its own phase
    through ``_batch_path``, as in 9: the random-init phases' launches a
    roundtrip, the shapes, the ragged request and the rows of the first
    that the family's phase compares (all 8 of EnCodec's, DAC's one,
    rows 0-1 elsewhere) against the CPU path on the same converted
    weights (features within 1e-4 of max|feats|, token_match ≥ 0.999, the
    decode of the same tokens within 1e-4 of max|sig|), the warm
    roundtrip and its profile. And DAC-44.1k on the same draw at unit
    gain (``_dac_unit_gain``)."""
    _drive_loaded_families(torch, rows, 35, seed0=0)


# Slice 15: the rest of the zoo on converted checkpoints
SEMANTICODEC_WINDOW = 163840  # one 10.24 s window at 16 kHz


def _zoo_loading():
    """(path, registry name, model config, constructor keywords, the
    checkpoint's schema (files → key → shape, or key → shape), the
    converter ``(ckpt, mc) → state``, the token margin or None, the
    decode's limit as a share of max|sig|) of the nine families of the
    rest of the zoo that phase 36 loads for one short request. WavLM+
    K-means' k-means centroids and dequantizer, which no converter
    covers, are drawn in the port's layout; SemantiCodec is assembled by
    ``convert_semanticodec_components`` from its five released pieces."""
    import dataclasses

    from audiocodecs_tpu_torch.convert import ldm
    from audiocodecs_tpu_torch.convert import zoo as z
    from audiocodecs_tpu_torch.convert.audiomae import audiomae_schema
    from audiocodecs_tpu_torch.convert.torch_utils import (
        put_linear, to_tensor)
    from audiocodecs_tpu_torch.convert.wavlm import convert_wavlm_state_dict
    from audiocodecs_tpu_torch.models import get_codec_class

    def published(name, **kw):
        mc = get_codec_class(name).default_model_config()
        return dataclasses.replace(mc, **kw) if kw else mc

    wk = published("wavlm_kmeans", vocoder_variant="hifigan")
    H = wk.wavlm.hidden_size

    def wavlm_kmeans(ck, mc):
        out = {f"wavlm.{k}": v for k, v in
               convert_wavlm_state_dict(ck["wavlm"], mc.wavlm).items()}
        out.update({f"vocoder.{k}": v for k, v in
                    z.convert_wavlm_kmeans_vocoder(ck["vocoder"],
                                                   mc.hifigan()).items()})
        rest = {}
        put_linear(rest, "dequantizer", ck["rest"], "dequantizer")
        rest["kmeans"] = ck["rest"]["kmeans.codebook"]
        out.update({k: to_tensor(v) for k, v in rest.items()})
        return out

    sc = published("semanticodec")
    ldm_spec = {**{f"first_stage_model.{k}": v for k, v in
                   ldm.vae_schema(sc.vae_cfg).items()},
                **{f"model.diffusion_model.{k}": v for k, v in
                   ldm.unet_schema(sc.unet()).items()}}

    def semanticodec(ck, mc):
        # the latent scale as the random-init phase sets it
        ldm_sd = {**ck["ldm"], "scale_factor": np.float32(1.0)}
        return z.convert_semanticodec_components(
            mc, audiomae_sd=ck["audiomae"], ldm_sd=ldm_sd,
            vocoder_sd=ck["vocoder"], base_params={},
            centroids=ck["codebooks"]["semantic.codebook"],
            acoustic_codebook=ck["codebooks"]["acoustic.codebook"])

    def one(name):
        return (getattr(z, f"{name}_schema"),
                getattr(z, f"convert_{name}_state_dict"))

    return (
        ("stablecodec_16k", "stablecodec", published("stablecodec"), {},
         *one("stablecodec"), None, 1e-4),
        ("nanocodec_22k", "nanocodec", published("nanocodec"), {},
         *one("nanocodec"), None, 1e-4),
        ("audiodec_24k", "audiodec", published("audiodec"),
         {"num_codebooks": 8}, *one("audiodec"), None, 1e-4),
        ("magicodec_16k", "magicodec", published("magicodec"), {},
         *one("magicodec"), None, 1e-4),
        ("focalcodec_16k", "focalcodec", published("focalcodec"), {},
         *one("focalcodec"), _focal_margin, 1e-4),
        ("hilcodec_24k", "hilcodec", published("hilcodec"),
         {"num_codebooks": 8}, z.hilcodec_schema,
         z.convert_hilcodec_full_state_dict, None, 1e-4),
        ("dycast_16k", "dycast", published("dycast"), {}, *one("dycast"),
         _dycast_margin, 1e-4),
        ("wavlm_kmeans_hifigan_16k", "wavlm_kmeans", wk, {},
         lambda mc: {"wavlm": z.wavlm_schema(mc.wavlm),
                     "vocoder": ldm.hifigan_schema(mc.hifigan()),
                     "rest": {"kmeans.codebook": (1, mc.num_clusters, H),
                              "dequantizer.weight": (H, H),
                              "dequantizer.bias": (H,)}},
         wavlm_kmeans, None, 1e-4),
        ("semanticodec_16k", "semanticodec", sc, {"ddim_sample_step": 2},
         lambda mc: {"audiomae": audiomae_schema(mc.audiomae()),
                     "ldm": ldm_spec,
                     "vocoder": ldm.hifigan_schema(mc.vocoder_cfg),
                     "codebooks": {
                         "semantic.codebook": (mc.semantic_vocab,
                                               mc.feature_dim),
                         "acoustic.codebook": (mc.acoustic_vocab,
                                               mc.feature_dim)}},
         semanticodec, None, max(1e-4, SEMANTICODEC_FP32_GAP)),
    )


def phase_zoo_loading(torch, rows):
    """36. The rest of the zoo on converted checkpoints. X-Codec 2.0-16k
    and BiCodec-16k at their published widths as phase 35 drives its five
    (``_drive_loaded_families``): their phases' requests (two B = 8 x 5
    s, one ragged), launches (X-Codec 2.0 B1 wide 2, BiCodec B4 6 a
    roundtrip), shapes and parity rows, the FSQ margins. Then StableCodec,
    NanoCodec, AudioDec, MagiCodec, FocalCodec, HILCodec (its whole
    towers), DyCAST, WavLM+K-means with its HiFi-GAN vocoder and
    SemantiCodec (from its AudioMAE, centroids, codebook, LDM and vocoder
    files) at their published widths: each checkpoint drawn as in 35,
    converted on the host and loaded on the card (both timed), one short
    request (B = 1 x 2 s, or SemantiCodec's one 10.24 s window at 2 DDIM
    steps) through ``sig_to_toks`` and ``toks_to_sig``: no kernel
    launch, tokens equal to the CPU path's on the same weights, the
    decode of the same tokens within its family's limit of max|sig|
    (1e-4, SemantiCodec's the larger of it and the fp32 gap), the token
    margin where the family's phase prints one."""
    _drive_loaded_families(torch, rows, 36, seed0=5)
    _drive_zoo_loading(torch, rows, seed0=7)


def _drive_zoo_loading(torch, rows, seed0: int):
    """The nine of ``_zoo_loading`` (phase 36's second part); a family that
    misses is named at the end, after the others ran."""
    from audiocodecs_tpu_torch.models import get_codec_class

    card = _card_line()
    rng = np.random.default_rng(36)
    misses = []
    for seed, (path, name, mc, kw, schema, convert, margin,
               limit) in enumerate(_zoo_loading(), seed0):
        ckpt = _checkpoint(path, schema(mc), seed)
        t0 = time.perf_counter()
        state = convert(ckpt, mc)
        convert_ms = (time.perf_counter() - t0) * 1e3
        del ckpt
        cls = get_codec_class(name)
        codec, load_ms = _load_timed(torch, cls, mc, state, kw)
        cpu = cls(mc.sampling_rate, mc.sampling_rate, model_config=mc,
                  state_dict=state, device="cpu", **kw)
        del state
        n = (SEMANTICODEC_WINDOW if name == "semanticodec"
             else 2 * mc.sampling_rate)
        (sig,) = _noise(rng, [(1, n)])
        path = f"{path}_loaded"
        reset_counts()
        toks = codec.sig_to_toks(sig)
        y = codec.toks_to_sig(toks)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != _launch_table(0, 0):
            fail(f"{path}: expected no kernel launches, got {counts}")
        _add_launches(rows, path, counts)
        t0 = time.perf_counter()
        toks_cpu = cpu.sig_to_toks(sig)
        y_cpu = cpu.toks_to_sig(toks.cpu())
        cpu_s = time.perf_counter() - t0
        same = tuple(toks.shape) == tuple(toks_cpu.shape) and bool(
            (toks.cpu() == toks_cpu).all())
        scale = float(y_cpu.abs().max())
        err = float((y.cpu() - y_cpu).abs().max())
        log(f"{path} B=1 x {n / mc.sampling_rate:g} s: toks "
            f"{tuple(toks.shape)} equal to the CPU path's: {same}; decode "
            f"max_abs_diff={err:.3e} (limit {limit * scale:.3e}, max|sig| "
            f"{scale:.4e}, {float((y_cpu.abs() > 0.99).float().mean()):.3f}"
            f" of the samples above 0.99); convert_ms={convert_ms:.1f} "
            f"load_ms={load_ms:.1f}; cpu_seconds={cpu_s:.1f}; card: {card}")
        if not same:
            misses.append(f"{path}: tokens differ from the CPU path's")
        if not bool(torch.isfinite(y).all()) or not err <= limit * scale:
            misses.append(f"{path}: the decode disagrees with the CPU path")
            _float64_gap(torch, path, cpu, toks, y, y_cpu)
        if margin is not None:
            margin(torch, path, codec, cpu, sig)
        del codec, cpu
        torch.cuda.empty_cache()
        if name == "nanocodec":
            _nanocodec_unit_gain(torch, mc, kw, schema, convert, seed, sig)
            torch.cuda.empty_cache()
    if misses:
        fail("; ".join(misses))


def _float64_gap(torch, path, cpu, toks, y, y_cpu):
    """The CPU path's float32 decode and the card's against the CPU path in
    float64 (``cpu`` is cast), on the same tokens. Two gaps of one size
    are fp32 conditioning; a card much further off than the CPU is not."""
    with torch.inference_mode():
        q = cpu._toks_to_qfeats(toks.cpu(), None)
        y64 = cpu.double()._feats_to_sig(q.double(), None)
    e_cpu = float((y_cpu.double() - y64).abs().max())
    e_card = float((y.cpu().double() - y64).abs().max())
    log(f"{path} against float64 on the CPU: CPU float32 {e_cpu:.3e}, "
        f"card {e_card:.3e}")


def _nanocodec_unit_gain(torch, mc, kw, schema, convert, seed, sig):
    """NanoCodec-22.05k on phase 36's draw at unit gain (its units'
    closing ``skip_conv`` not cut to a tenth), where the decode of the
    same tokens parts from the CPU path's by more than 1e-4 of max|sig|
    with no kernel on the path: its tanh-saturated share, and the card's
    and the CPU path's float32 decodes against float64 (``_float64_gap``)."""
    from audiocodecs_tpu_torch.models.nanocodec import NanoCodec

    state = convert(_synth_checkpoint(schema(mc), seed, closing=1.0), mc)
    sr = mc.sampling_rate
    codec = NanoCodec(sr, sr, model_config=mc, state_dict=state,
                      device="cuda", **kw)
    cpu = NanoCodec(sr, sr, model_config=mc, state_dict=state,
                    device="cpu", **kw)
    del state
    toks = codec.sig_to_toks(sig)
    y, y_cpu = codec.toks_to_sig(toks).cpu(), cpu.toks_to_sig(toks.cpu())
    scale = float(y_cpu.abs().max())
    path = "nanocodec_22k_loaded unit gain"
    log(f"{path}: decode max_abs_diff={float((y - y_cpu).abs().max()):.3e}"
        f" (1e-4 of max|sig| is {1e-4 * scale:.3e}); "
        f"{float((y_cpu.abs() > 0.99).float().mean()):.3f} of the samples "
        f"above 0.99")
    _float64_gap(torch, path, cpu, toks, y, y_cpu)
    del codec, cpu


WORK_DIR = Path("results") / "chip_smoke"  # git-ignored, in the checkout
LONG_AUDIO = (24000, 25.0, 10.0)  # EnCodec-24k: rate, request s, window s


def phase_long_audio(torch, rows):
    """``windowed_reconstruct`` on EnCodec-24k at B = 1 x 25 s in 10 s
    windows (three: 4 B1 and 8 B2 launches each) against the CPU path on the
    same weights; the native WAV writer and reader on the card's host
    against the ``wave`` path; the ``reconstruct`` and ``stream`` examples'
    ``main()`` on the card."""
    from audiocodecs_tpu_torch.examples import reconstruct, stream
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.utils.audio import read_wav, write_wav
    from audiocodecs_tpu_torch.utils.windowed import windowed_reconstruct

    sr, seconds, window = LONG_AUDIO
    codec, cpu = _server_pair(torch, Encodec, sr, sr, num_codebooks=8)
    sig = _noise(np.random.default_rng(37), [(1, int(sr * seconds))])[0]
    path = "windowed_encodec_24k"
    reset_counts()
    t0 = time.perf_counter()
    y = windowed_reconstruct(codec, sig, window_seconds=window)
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"{path} launches: {json.dumps(counts)}")
    want = _launch_table(12, 24)
    if counts != want:
        fail(f"{path}: expected launches {want}, got {counts}")
    _add_launches(rows, path, counts)
    t0 = time.perf_counter()
    y_cpu = windowed_reconstruct(cpu, sig, window_seconds=window)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(y - y_cpu).max())
    lim = 1e-4 * float(np.abs(y_cpu).max())
    log(f"{path} B=1 x {seconds} s in {window} s windows: {wall * 1e3:.1f} "
        f"ms wall on the card (first call); max_abs_diff against the CPU "
        f"{err:.3e} (limit {lim:.3e}); cpu_seconds={cpu_s:.1f}")
    if y.shape != sig.shape or not np.isfinite(y).all():
        fail(f"{path}: output {y.shape}, finite {np.isfinite(y).all()}")
    if not err <= lim:
        fail(f"{path}: disagrees with the CPU path")
    t0 = time.perf_counter()
    windowed_reconstruct(codec, sig, window_seconds=window)
    warm = time.perf_counter() - t0
    log(f"{path} warm: {warm * 1e3:.1f} ms wall (host crossfade included), "
        f"rtf={seconds / warm:.1f}")

    # the two WAV paths in turns, five times each (the first call of the
    # native path also loads its library)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    wavs, ms = {}, {True: ([], []), False: ([], [])}
    for _ in range(5):
        for native in (True, False):
            f = WORK_DIR / f"long_{native}.wav"
            t0 = time.perf_counter()
            write_wav(str(f), y, sr, native=native)
            t1 = time.perf_counter()
            back, back_sr = read_wav(str(f), native=native)
            ms[native][0].append((t1 - t0) * 1e3)
            ms[native][1].append((time.perf_counter() - t1) * 1e3)
            wavs[native] = (f.read_bytes(), back, back_sr)
    for native, (w, r) in ms.items():
        log(f"wav {'native' if native else 'wave'} ({y.size} samples, 16-bit):"
            f" write median {statistics.median(w):.3f} ms (first "
            f"{w[0]:.3f}), read median {statistics.median(r):.3f} ms (first "
            f"{r[0]:.3f})")
    if wavs[True][0] != wavs[False][0]:
        fail("native and wave writers wrote different bytes")
    if not (wavs[True][2] == wavs[False][2] == sr and np.array_equal(
            wavs[True][1], wavs[False][1])):
        fail("native and wave readers disagree")

    for name, main, argv, want in (
            ("reconstruct_example", reconstruct.main,
             ["--out", str(WORK_DIR / "reconstruction.wav")],
             _launch_table(4, 8)),
            ("stream_example", stream.main, [], _launch_table(0, 0))):
        reset_counts()
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"{name}: rc={rc}, {time.perf_counter() - t0:.1f} s, launches "
            f"{json.dumps(counts)}")
        if rc != 0:
            fail(f"{name} exited {rc}")
        if counts != want:
            fail(f"{name}: expected launches {want}, got {counts}")
        _add_launches(rows, name, counts)


PROFILE_SECONDS = 1  # the SR sweep's use_profiler length
SWEEP_PER_ROUNDTRIP = {"encodec": (4, 8, 0), "dac": (0, 0, 6),
                       "mimi": (0, 0, 0), "speechtokenizer": (6, 0, 0)}
# (B1, B2, B4) launches of each codec's decode alone
SWEEP_PER_DECODE = {"encodec": (2, 4, 0), "dac": (0, 0, 6),
                    "mimi": (0, 0, 0), "speechtokenizer": (2, 0, 0)}
SR_LIMITS = {"sisnr": (0.01, 0), "meld": (0, 1e-3), "stftd": (0, 1e-3),
             "stoi": (1e-3, 0), "pesq": (0.02, 0), "dnsmos": (1e-3, 0)}


def _sr_stats(out_dir: Path) -> dict:
    """Per-utterance values of the metric files ``run_sr`` wrote."""
    out = {}
    for f in sorted(out_dir.glob("*.txt")):
        if f.name == "profiler.txt":
            continue
        lines = f.read_text().splitlines()[1:-1]
        out[f.stem] = {u: float(v) for u, v in (ln.split("\t")
                                                for ln in lines)}
    return out


def phase_sweep_sr(torch, rows):
    """The ``sweep_sr`` example over its four default codecs at their
    published widths (EnCodec-24k, DAC-16k, Mimi-24k, SpeechTokenizer-16k
    at the registry's rates) on the synthetic corpus of
    ``hparams/datasets/synthetic.yaml``, on the card: launches a roundtrip,
    the summary keys, EnCodec's summary against ``run_sr`` on the CPU with
    the same weights, its tokens against the CPU's, and the DNSMOS time an
    utterance."""
    import yaml

    from audiocodecs_tpu_torch.downstream.config import build_codec
    from audiocodecs_tpu_torch.downstream.datasets.loader import (
        BucketedLoader)
    from audiocodecs_tpu_torch.downstream.datasets.manifest import (
        read_manifest)
    from audiocodecs_tpu_torch.downstream.metrics.dnsmos import dnsmos_p808
    from audiocodecs_tpu_torch.downstream.recipes.common import prepare_data
    from audiocodecs_tpu_torch.downstream.recipes.sr import run_sr
    from audiocodecs_tpu_torch.examples import sweep_sr
    from audiocodecs_tpu_torch.utils.audio import read_wav

    work = WORK_DIR / "sweep_sr"
    ds = yaml.safe_load(Path("hparams/datasets/synthetic.yaml").read_text())
    ds["prep_dir"] = str(work / "corpus")
    ds_path = work / "synthetic.yaml"
    work.mkdir(parents=True, exist_ok=True)
    ds_path.write_text(yaml.safe_dump(ds))
    # the shipped task with use_profiler on: each codec also writes its
    # profile at 1 s (profiler.txt and the summary's "profiler" key)
    task = "hparams/tasks/sr.yaml"
    tcfg = yaml.safe_load(Path(task).read_text())
    tcfg.update(use_profiler=True, profiler_seconds=[PROFILE_SECONDS])
    task_path = work / "sr_profiled.yaml"
    task_path.write_text(yaml.safe_dump(tcfg))
    reset_counts()
    t0 = time.perf_counter()
    rc = sweep_sr.main(["--dataset", str(ds_path), "--task", str(task_path),
                        "--output_folder", str(work / "card")])
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"sweep_sr: rc={rc}, {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(counts)}")
    if rc != 0:
        fail(f"sweep_sr exited {rc}")

    # roundtrips a codec: one a batch, and for the timer (the chain-length
    # slope over rtf_reps = (lo, hi)) 3 (lo + hi) encodes and as many
    # decodes a distinct batch shape: each length once warm, twice timed
    cfg = yaml.safe_load(Path(task).read_text())
    lo, hi = cfg["rtf_reps"]
    test_rows = read_manifest(ds["test_csv"].replace("{prep_dir}",
                                                     ds["prep_dir"]))
    loader = BucketedLoader(test_rows, ds["sample_rate"],
                            batch_size=4,
                            num_buckets=int(cfg["num_length_buckets"]))
    plan = loader._plan()
    n_shapes = len({(len(r), t) for r, t in plan})
    # and the profile: 2 warm calls, 1 counted, 5 timed, 2 spans of 4, 1
    # for the memory
    n_rt = len(plan) + 3 * (lo + hi) * n_shapes + 17
    lstm = n_rt * sum(v[0] for v in SWEEP_PER_ROUNDTRIP.values())
    block = n_rt * sum(v[1] for v in SWEEP_PER_ROUNDTRIP.values())
    unit = n_rt * sum(v[2] for v in SWEEP_PER_ROUNDTRIP.values())
    want = _launch_table(lstm, block, unit)
    if counts != want:
        fail(f"sweep_sr: expected launches {want} ({n_rt} roundtrips a "
             f"codec), got {counts}")
    _add_launches(rows, "sweep_sr", counts)

    card = {n: json.loads((work / "card" / n / "summary.json").read_text())
            for n in SWEEP_PER_ROUNDTRIP}
    for n, s in card.items():
        log(f"sweep_sr {n}: iRTF={s['iRTF']:.3f} RTF={s['RTF']:.6f} "
            f"RealTime={s['RealTime']:.4f} s ProcessTimeEncode="
            f"{s['ProcessTimeEncode']:.6f} s ProcessTimeDecode="
            f"{s['ProcessTimeDecode']:.6f} s SISNR={s['SISNR']:.3f} "
            f"MelD={s['MelD']:.3f} STOI={s['STOI']:.4f} PESQ={s['PESQ']:.3f} "
            f"DNSMOS={s['DNSMOS']:.4f} codebook_util="
            f"{s['codebook_util']:.4f} batches={s['num_batches']}")

    # EnCodec on the CPU, same weights (seed 0) and config
    ecfg = prepare_data({**cfg, **ds, "codec": {"name": "encodec"},
                         "test_batch_size": 4,
                         "output_folder": str(work / "cpu" / "encodec")})
    t0 = time.perf_counter()
    cpu_summary = run_sr(ecfg, device="cpu")
    log(f"sweep_sr encodec on the CPU: {time.perf_counter() - t0:.1f} s")
    for n, s in card.items():
        report = work / "card" / n / "profiler.txt"
        if sorted(s.pop("profiler", {})) != ["params_m"] or (
                not report.is_file()):
            fail(f"sweep_sr {n}: use_profiler wrote no profiler.txt or no "
                 f"profiler key")
        log(f"sweep_sr {n} profiler.txt: "
            f"{' | '.join(report.read_text().splitlines()[1:])}")
        if sorted(s) != sorted(cpu_summary):
            fail(f"sweep_sr {n}: summary keys {sorted(s)} != the CPU run's "
                 f"{sorted(cpu_summary)}")
    got = _sr_stats(work / "card" / "encodec")
    ref = _sr_stats(work / "cpu" / "encodec")
    worst = {}
    for name, vals in ref.items():
        metric = name
        for prefix in ("rec", "ref", "orig"):
            if name.startswith(prefix) and name[len(prefix):] in SR_LIMITS:
                metric = name[len(prefix):]
        atol, rtol = SR_LIMITS[metric]
        for uid, w in vals.items():
            d = abs(got[name][uid] - w)
            worst[name] = max(worst.get(name, 0.0), d)
            if not d <= atol + rtol * abs(w) + 1e-6:
                fail(f"sweep_sr encodec {name} {uid}: card {got[name][uid]}"
                     f" against CPU {w}")
    log(f"sweep_sr encodec card against CPU, largest gap a metric: "
        f"{json.dumps({k: round(v, 7) for k, v in worst.items()})}")
    if cpu_summary["codebook_util"] != card["encodec"]["codebook_util"]:
        log(f"sweep_sr encodec codebook_util card "
            f"{card['encodec']['codebook_util']} CPU "
            f"{cpu_summary['codebook_util']}")
    gpu_codec = build_codec(ecfg, ds["sample_rate"])
    cpu_codec = build_codec(ecfg, ds["sample_rate"], device="cpu")
    mism = total = 0
    for batch in loader:
        t_gpu = gpu_codec.sig_to_toks(batch["sig"], batch["length"]).cpu()
        t_cpu = cpu_codec.sig_to_toks(batch["sig"], batch["length"])
        mism += int((t_gpu != t_cpu).sum())
        total += t_cpu.numel()
    match = 1.0 - mism / total
    log(f"sweep_sr encodec tokens card against CPU: token_match="
        f"{match:.6f} ({mism} of {total} differ)")
    if not match >= 0.999:
        fail(f"sweep_sr encodec: token_match {match} < 0.999")

    # the shape timers once more on each codec: how far the slope's iRTF
    # moves between two passes (the sweep's and this one) in one process
    from audiocodecs_tpu_torch.downstream.recipes.sr import (
        _make_shape_timers)

    reset_counts()
    t0 = time.perf_counter()
    for n in SWEEP_PER_ROUNDTRIP:
        codec = build_codec(prepare_data({**cfg, **ds, "codec": {"name": n}}),
                            ds["sample_rate"])
        enc, dec = _make_shape_timers(codec, (lo, hi))
        seconds = real = 0.0
        for batch in loader:
            sig = torch.from_numpy(np.asarray(batch["sig"])).cuda()
            seconds += enc(sig) + dec(codec.sig_to_toks(sig))
            real += float(np.sum(batch["length"])
                          * sig.shape[1]) / ds["sample_rate"]
        log(f"sweep_sr {n} iRTF, two passes of the shape timers (rtf_reps "
            f"{lo}, {hi}): {card[n]['iRTF']:.3f} (the sweep's) and "
            f"{real / seconds:.3f}")
        del codec
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"sweep_sr second timer pass: {time.perf_counter() - t0:.1f} s, "
        f"launches {json.dumps(counts)}")
    # an encode a batch, then the timer's roundtrips
    n_rt, n_enc = 3 * (lo + hi) * n_shapes, len(plan)
    want = _launch_table(*(
        sum(n_rt * v[i] + n_enc * (v[i] - SWEEP_PER_DECODE[n][i])
            for n, v in SWEEP_PER_ROUNDTRIP.items()) for i in range(3)))
    if counts != want:
        fail(f"sweep_sr second timer pass: expected launches {want}, got "
             f"{counts}")
    _add_launches(rows, "sweep_sr_timer_pass", counts)

    # DNSMOS a test utterance on the card (wall, host included: the
    # tiling, the copy in, the score out)
    x, rate = read_wav(read_manifest(ecfg["test_csv"])[0]["wav"])
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        dnsmos_p808(x[0], rate)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"DNSMOS a {x.shape[1] / rate:.2f} s utterance on the card: "
        f"median {statistics.median(times[2:]):.2f} ms wall (host "
        f"included), {len(times) - 2} warm calls")
    del gpu_codec, cpu_codec


# Whisper large-v3's special tokens at their ids in its 51866-token
# vocabulary (the synthetic vocabulary phase 39 writes keeps them there)
WHISPER_V3_SPECIALS = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258,
                       "<|en|>": 50259, "<|transcribe|>": 50360,
                       "<|notimestamps|>": 50364}
PPL_TEXTS = ["the cat sat on the hat", "that theatre is at the heath",
             "a cat that sat there"]
METRIC_SECONDS = (1, 2, 4)  # the profiler's sweep of EnCodec-24k, B = 1


def _synthetic_vocab(d: Path, size: int, specials: dict) -> None:
    """A byte-level vocabulary of ``size`` tokens (256 bytes, GPT-2's merge
    chains for "the", " the" and "cat", filler tokens) with ``specials`` at
    their ids, and its ``merges.txt``, written to ``d``."""
    from audiocodecs_tpu_torch.utils.bytebpe import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    sp = b2u[ord(" ")]
    merges = [("t", "h"), ("th", "e"), (sp, "t"), (sp + "t", "h"),
              (sp + "th", "e"), ("a", "t"), ("c", "at")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    free = (i for i in range(len(vocab), size)
            if i not in specials.values())
    while len(vocab) + len(specials) < size:
        i = next(free)
        vocab[f"<filler{i}>"] = i
    vocab.update(specials)
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


def _on_card(torch, cls, cfg, init, seed: int):
    """``cls(cfg)`` with ``init``'s seeded weights drawn on the card (a
    CUDA generator), built on the meta device and assigned, so the weights
    are never held twice."""
    with torch.device("meta"):
        model = cls(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.load_state_dict(init(gen, cfg), strict=True, assign=True)
    return model.eval()


def _pair_cpu(torch, cls, cfg, init, seed: int):
    """``cls(cfg)`` on the CPU from a seeded CPU draw, and its twin on the
    card."""
    cpu = cls(cfg)
    cpu.load_state_dict(init(torch.Generator().manual_seed(seed), cfg))
    card = cls(cfg)
    card.load_state_dict(cpu.state_dict())
    return cpu.eval(), card.to("cuda").eval()


def _rel(got, want) -> float:
    """max |got - want| / max |want| (both moved to the CPU)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _hold(label: str, value: float, limit: float) -> None:
    log(f"{label}: {value:.3e} (limit {limit:.0e})")
    if not value <= limit:
        fail(f"{label} {value} above {limit}")


def _utmos_check(torch, rows, work, utts, noisy):
    from audiocodecs_tpu_torch.downstream.metrics import utmos
    from audiocodecs_tpu_torch.nn.lstm import bilstm, bilstm_masked

    cfg = utmos.UTMOSConfig()
    path = work / "utmos.pt"
    torch.save(utmos.init_utmos_params(torch.Generator().manual_seed(0),
                                       cfg), path)
    scores = {}
    for dev in ("cuda", "cpu"):
        for bucket in (0.0, 1.0):
            metric = utmos.make_utmos_checkpoint_metric(
                str(path), bucket_seconds=bucket, device=dev)
            if dev == "cuda":
                metric.metric(utts[:1], 16000)  # warm
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
            scores[dev, bucket] = np.asarray(metric.metric(utts, 16000))
            if dev == "cuda":
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = read_counts()
                log(f"UTMOS22 strong (bucket {bucket} s) on the card: "
                    f"{ms:.1f} ms wall for {len(utts)} utterances, B1 "
                    f"launches {counts['lstm_recurrence']}")
                if counts["lstm_recurrence"] != 2 * len(utts):
                    fail(f"UTMOS: expected {2 * len(utts)} B1 launches, "
                         f"got {counts}")
                _add_launches(rows, f"utmos_bucket{bucket:g}", counts)
                model = metric.model
    for bucket in (0.0, 1.0):
        card, cpu = scores["cuda", bucket], scores["cpu", bucket]
        log(f"UTMOS (bucket {bucket} s) card {card.tolist()} CPU "
            f"{cpu.tolist()}")
        _hold(f"UTMOS (bucket {bucket} s) card-CPU / max|score|",
              float(np.abs(card - cpu).max() / np.abs(cpu).max()), 1e-4)
    # bilstm_masked's valid frames against bilstm on each unpadded row,
    # the UTMOS BiLSTM's weights, on the card: each row alone (its padded
    # row against its valid frames: the masking, and the kernel's rows),
    # and the three rows in one padded batch, whose input projection is
    # one [3 · 150, 1024] x [1024, 2048] product where the unpadded rows'
    # are [n, 1024] ones: cuBLAS sums those in another order; beside them
    # the plain bilstm's own card-CPU gap on a row, that order's scale
    params = [p.params() for p in model.blstm]
    cpu_params = [{d: {k: t.cpu() for k, t in q.items()} for d, q in
                   p.items()} for p in params]
    lens = [150, 97, 33]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(3, 150, cfg.feat_dim, device="cuda", generator=gen)
    with torch.inference_mode():
        alone = max(_rel(bilstm_masked(x[i:i + 1], params, torch.tensor(
            [n], device="cuda"))[0, :n], bilstm(x[i:i + 1, :n], params)[0])
            for i, n in enumerate(lens))
        masked = bilstm_masked(x, params, torch.tensor(lens, device="cuda"))
        batch = max(_rel(masked[i, :n], bilstm(x[i:i + 1, :n], params)[0])
                    for i, n in enumerate(lens))
        plain = _rel(bilstm(x[2:3, :33], params),
                     bilstm(x[2:3, :33].cpu(), cpu_params))
    log(f"bilstm_masked against bilstm on the unpadded rows, relative: "
        f"{alone:.3e} each row alone, {batch:.3e} in the B = 3 batch; "
        f"bilstm card-CPU {plain:.3e}")
    _hold("bilstm_masked valid frames against bilstm (each row alone), "
          "relative", alone, 1e-6)
    del model


def _xvector_check(torch, work, utts, noisy):
    from audiocodecs_tpu_torch.downstream.metrics import external
    from audiocodecs_tpu_torch.downstream.models import speaker_encoder as xv

    path = work / "xvector.pt"
    torch.save(xv.init_xvector_params(torch.Generator().manual_seed(1),
                                      xv.XVectorConfig()), path)
    card = external.make_speaker_similarity_metric(checkpoint=str(path))
    cpu = external.make_speaker_similarity_metric(checkpoint=str(path),
                                                  device="cpu")
    card.embed(utts[:1], 16000)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_card = card.embed(utts, 16000)
    ms = (time.perf_counter() - t0) * 1e3
    e_cpu = cpu.embed(utts, 16000)
    log(f"WavLM x-vector on the card: {ms:.1f} ms wall for {len(utts)} "
        f"utterances, embeddings {e_card.shape}")
    _hold("x-vector card-CPU / max|e|",
          float(np.abs(e_card - e_cpu).max() / np.abs(e_cpu).max()), 1e-4)
    s_card = np.asarray(card.metric(noisy, utts, 16000))
    s_cpu = np.asarray(cpu.metric(noisy, utts, 16000))
    log(f"SpkSim card {s_card.tolist()} CPU {s_cpu.tolist()}")
    _hold("SpkSim card-CPU", float(np.abs(s_card - s_cpu).max()), 1e-5)


def _whisper_v3():
    from audiocodecs_tpu_torch.nn.whisper import WhisperConfig

    # openai/whisper-large-v3's config.json
    return WhisperConfig(
        vocab_size=51866, num_mel_bins=128, d_model=1280,
        encoder_layers=32, encoder_heads=20, decoder_layers=32,
        decoder_heads=20, encoder_ffn=5120, decoder_ffn=5120,
        max_source_positions=1500, max_target_positions=448,
        eos_token=50257, decoder_start_token=50258)


def _whisper_check(torch, work, utts, noisy):
    import dataclasses

    from audiocodecs_tpu_torch.downstream.metrics.dwer import (
        dwer_metric, whisper_forced_tokens)
    from audiocodecs_tpu_torch.nn import whisper
    from audiocodecs_tpu_torch.utils.bytebpe import ByteLevelBPE

    tok = work / "whisper_vocab"
    cfg = _whisper_v3()
    _synthetic_vocab(tok, cfg.vocab_size, WHISPER_V3_SPECIALS)
    forced = whisper_forced_tokens(ByteLevelBPE.from_dir(str(tok)),
                                   cfg.decoder_start_token)
    wav = np.zeros((len(utts), 30 * 16000), np.float32)
    for i, u in enumerate(utts):
        wav[i, :u.size] = u
    wav_t = torch.from_numpy(wav)

    # full depth on the card: encode, a decode step, dWER end to end
    t0 = time.perf_counter()
    full = _on_card(torch, whisper.Whisper, cfg,
                    whisper.init_whisper_params, 0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in full.parameters())
    log(f"Whisper large-v3 ({n_params / 1e9:.3f} G parameters) drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        mel = whisper.log_mel_spectrogram(wav_t.cuda(), cfg.num_mel_bins)
        enc_ms = cuda_ms(torch, lambda: whisper.whisper_encode(full, mel),
                         reps=3, warmup=1)
        enc = whisper.whisper_encode(full, mel)
        steps = len(forced) + 31  # the prompt's and 31 of 32 new tokens
        gen_ms = cuda_ms(torch, lambda: whisper.whisper_generate(
            full, mel, forced, 32, enc_states=enc), reps=2, warmup=1)
    log(f"Whisper large-v3 at B = {len(utts)} x 30 s: encode "
        f"{enc_ms:.2f} ms; 32 new tokens {gen_ms:.2f} ms, "
        f"{gen_ms / steps:.3f} ms a decode step ({steps} steps, the "
        f"cross-attention K/V included)")
    metric = dwer_metric(full, str(tok), max_new_tokens=32)
    t0 = time.perf_counter()
    w = metric.metric(noisy, utts, 16000)
    c = metric.cer(noisy, utts, 16000)
    log(f"dWER {w} dCER {c} (full depth, 32 new tokens, "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms wall)")
    if not all(np.isfinite(w + c)):
        fail("dWER/dCER not finite")
    del full, metric, enc
    torch.cuda.empty_cache()

    # the same widths at 2 + 2 layers, card against CPU
    cfg2 = dataclasses.replace(cfg, encoder_layers=2, decoder_layers=2)
    cpu, card = _pair_cpu(torch, whisper.Whisper, cfg2,
                          whisper.init_whisper_params, 1)
    with torch.inference_mode():
        mel_cpu = whisper.log_mel_spectrogram(wav_t, cfg.num_mel_bins)
        mel_card = whisper.log_mel_spectrogram(wav_t.cuda(),
                                               cfg.num_mel_bins)
        _hold("Whisper log-mel card-CPU, relative", _rel(mel_card, mel_cpu),
              1e-4)
        enc_cpu = whisper.whisper_encode(cpu, mel_cpu)
        enc_card = whisper.whisper_encode(card, mel_card)
        _hold("Whisper encoder states (2 layers) card-CPU, relative",
              _rel(enc_card, enc_cpu), 1e-4)
        ids_cpu, n_cpu = whisper.whisper_generate(cpu, mel_cpu, forced, 32,
                                                  enc_states=enc_cpu)
        ids_card, n_card = whisper.whisper_generate(card, mel_card, forced,
                                                    32, enc_states=enc_card)
        seq = torch.cat([torch.tensor([forced] * len(utts)), ids_cpu], 1)
        lg_cpu = whisper.whisper_decode(cpu, seq, enc_cpu)
        lg_card = whisper.whisper_decode(card, seq.cuda(), enc_card).cpu()
    gap = float((lg_card - lg_cpu).abs().max())
    _hold("Whisper teacher-forced logits (2 + 2 layers) card-CPU / "
          "max|logits|", gap / float(lg_cpu.abs().max()), 1e-4)
    top2 = lg_cpu[:, len(forced) - 1:-1].topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    log(f"Whisper greedy ids: {int((ids_card.cpu() != ids_cpu).sum())} of "
        f"{ids_cpu.numel()} differ; least top-2 logit margin {margin:.3e} "
        f"against the largest card-CPU logit gap {gap:.3e}")
    if not torch.equal(ids_card.cpu(), ids_cpu) or not torch.equal(
            n_card.cpu(), n_cpu):
        fail("Whisper greedy ids differ between the card and the CPU")
    del cpu, card


def _gpt2_check(torch, work):
    import dataclasses

    from audiocodecs_tpu_torch.downstream.metrics.ppl import (
        perplexity_metric)
    from audiocodecs_tpu_torch.nn import gpt2
    from audiocodecs_tpu_torch.utils.bytebpe import ByteLevelBPE

    tok = work / "gpt2_vocab"
    # openai-community/gpt2-large's config.json
    cfg = gpt2.GPT2Config(vocab_size=50257, n_positions=1024, n_embd=1280,
                          n_layer=36, n_head=20)
    _synthetic_vocab(tok, cfg.vocab_size, {"<|endoftext|>": 50256})
    bpe = ByteLevelBPE.from_dir(str(tok))
    ids = [bpe.encode(t) for t in PPL_TEXTS]
    L = max(map(len, ids))
    toks = torch.zeros(len(ids), L, dtype=torch.long)
    for i, row in enumerate(ids):
        toks[i, :len(row)] = torch.tensor(row)
    lens = torch.tensor([len(r) for r in ids])
    full = _on_card(torch, gpt2.GPT2, cfg, gpt2.init_gpt2_params, 2)
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: gpt2.gpt2_nll(full, toks.cuda(),
                                                  lens.cuda()),
                     reps=5, warmup=2)
        nll = gpt2.gpt2_nll(full, toks.cuda(), lens.cuda()).cpu()
    ppl = perplexity_metric(full, str(tok)).metric(PPL_TEXTS)
    log(f"GPT-2 large (36 x 1280) NLL of {len(ids)} texts ({L} tokens): "
        f"{ms:.2f} ms; NLL {nll.tolist()}; PPL {ppl}")
    if not all(np.isfinite(ppl)):
        fail("GPT-2 PPL not finite")
    del full
    torch.cuda.empty_cache()
    cpu, card = _pair_cpu(torch, gpt2.GPT2, dataclasses.replace(
        cfg, n_layer=2), gpt2.init_gpt2_params, 3)
    with torch.inference_mode():
        got = gpt2.gpt2_nll(card, toks.cuda(), lens.cuda())
        want = gpt2.gpt2_nll(cpu, toks, lens)
    _hold("GPT-2 NLL (2 layers) card-CPU, relative", _rel(got, want), 1e-4)
    del cpu, card


def _profiler_check(torch, rows):
    from torch.utils.flop_counter import FlopCounterMode

    from audiocodecs_tpu_torch.downstream.profiler import profile_codec
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.nn.layers import exact_fp32

    codec, cpu = _server_pair(torch, Encodec, 24000)
    reset_counts()
    t0 = time.perf_counter()
    prof = profile_codec(codec, seconds=METRIC_SECONDS, batch=1)
    t_card = time.perf_counter() - t0
    counts = read_counts()
    # a length: 2 warm calls, 1 counted, 5 timed, 2 spans of 4, 1 for the
    # memory; 4 B1 and 8 B2 launches a roundtrip
    n = len(METRIC_SECONDS) * (2 + 1 + 5 + 2 * 4 + 1)
    want = _launch_table(4 * n, 8 * n)
    if counts != want:
        fail(f"profiler: expected launches {want}, got {counts}")
    _add_launches(rows, "profiler", counts)
    for sec in METRIC_SECONDS:
        r = prof[f"{sec}s"]
        sig = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, 24000 * sec)).astype(np.float32))
        with torch.inference_mode(), exact_fp32(), FlopCounterMode(
                display=False) as counter:
            cpu._toks_to_sig(cpu._sig_to_toks(sig, None), None)
        g_cpu = counter.get_total_flops() / 1e9
        log(f"profiler EnCodec-24k {sec} s: time_s {r['time_s'] * 1e3:.3f} "
            f"ms, time_min_s {r['time_min_s'] * 1e3:.3f} ms, "
            f"time_pipelined_s {r['time_pipelined_s'] * 1e3:.3f} ms, rtf "
            f"{r['rtf']:.1f}, gflops {r['gflops']:.4f} (CPU path "
            f"{g_cpu:.4f}), bytes_accessed_gb {r['bytes_accessed_gb']:.4f}, "
            f"peak {r['memory']['peak_bytes_in_use'] / 2 ** 20:.1f} MiB, "
            f"temp {r['memory']['temp_bytes'] / 2 ** 20:.1f} MiB")
        _hold(f"profiler {sec} s gflops card-CPU, relative",
              abs(r["gflops"] - g_cpu) / g_cpu, 0.01)
    log(f"profiler params_m {prof['params_m']:.3f}; profile_codec on the "
        f"card {t_card:.1f} s, the CPU path's counts "
        f"{time.perf_counter() - t0 - t_card:.1f} s")
    del codec, cpu


def phase_metric_models(torch, rows):
    """The SR evaluation's model-backed metrics at their published widths
    on seeded weights, and the profiler: UTMOS22 strong (B1 in its BiLSTM)
    and the WavLM x-vector on the synthetic test split against the CPU
    path; Whisper large-v3 at full depth (encode, a decode step, dWER and
    dCER) and at 2 + 2 layers against the CPU (log-mel, encoder states,
    teacher-forced logits, greedy ids with the token margin); GPT-2 large
    at full depth (NLL, PPL) and at 2 layers against the CPU; the profiler
    on EnCodec-24k at 1, 2 and 4 s (FLOPs against the CPU path's, times,
    peak memory, launches)."""
    import yaml

    from audiocodecs_tpu_torch.downstream.datasets.manifest import (
        read_manifest)
    from audiocodecs_tpu_torch.downstream.recipes.common import prepare_data
    from audiocodecs_tpu_torch.utils.audio import read_wav

    work = WORK_DIR / "metric_models"
    work.mkdir(parents=True, exist_ok=True)
    ds = yaml.safe_load(Path("hparams/datasets/synthetic.yaml").read_text())
    ds["prep_dir"] = str(work / "corpus")
    ds = prepare_data(ds)
    utts = [read_wav(r["wav"])[0][0] for r in read_manifest(ds["test_csv"])]
    rng = np.random.default_rng(7)
    noisy = [(u + 0.05 * rng.standard_normal(u.size)).astype(np.float32)
             for u in utts]
    log(f"metric models: {len(utts)} test utterances of "
        f"{[round(u.size / 16000, 2) for u in utts]} s")
    for label, check in (("UTMOS", lambda: _utmos_check(
            torch, rows, work, utts, noisy)),
            ("x-vector", lambda: _xvector_check(torch, work, utts, noisy)),
            ("Whisper", lambda: _whisper_check(torch, work, utts, noisy)),
            ("GPT-2", lambda: _gpt2_check(torch, work)),
            ("profiler", lambda: _profiler_check(torch, rows))):
        t0 = time.perf_counter()
        check()
        torch.cuda.empty_cache()
        log(f"metric models {label} seconds: {time.perf_counter() - t0:.1f}")


DOWNSTREAM_EPOCHS = {"ic": 2, "asr": 1, "se": 1, "ss": 1, "slm": 1,
                     "tts": 1, "vc": 1}
LLAMA_GREEDY = 32  # greedy tokens held equal on the card and the CPU


def _downstream_cfg(task: str, work: Path, codec: str = "encodec",
                    extra=(), out: str | None = None) -> dict:
    """``hparams/tasks/<task>.yaml`` + ``codecs/<codec>.yaml`` +
    ``datasets/synthetic.yaml`` (its corpus prepared under ``work``) with
    the CLI overrides ``extra``, the run's output under ``work/<out>``
    (``<task>`` by default), emptied first."""
    import shutil

    from audiocodecs_tpu_torch.downstream.config import parse_cli
    from audiocodecs_tpu_torch.downstream.recipes.common import prepare_data

    # a fresh run: no token cache or checkpoint of an earlier one
    out = out or task
    shutil.rmtree(work / out, ignore_errors=True)
    cfg, _ = parse_cli([f"hparams/tasks/{task}.yaml",
                        f"hparams/codecs/{codec}.yaml",
                        "hparams/datasets/synthetic.yaml",
                        "--prep_dir", str(work / "corpus"),
                        "--output_folder", str(work / out),
                        "--epochs", str(DOWNSTREAM_EPOCHS[task]), *extra])
    return prepare_data(cfg)


def _batches_by_split(cfg: dict) -> dict:
    """The loader's batches of each split, as the recipe iterates them."""
    from audiocodecs_tpu_torch.downstream.datasets.loader import (
        BucketedLoader)
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        loader_kwargs, read_split_manifests)

    rows = read_split_manifests(cfg)
    return {split: list(BucketedLoader(rows[split], int(cfg["sample_rate"]),
                                       shuffle=split == "train",
                                       seed=int(cfg.get("seed", 0)),
                                       **loader_kwargs(cfg)))
            for split in rows}


def _cached_batch(torch, batch, cache, dev):
    toks = cache.get_batch(batch["ids"])
    if toks is None:
        fail("downstream: a batch of the run is missing from its cache")
    return (torch.from_numpy(toks).to(dev),
            torch.from_numpy(np.asarray(batch["length"])).to(dev))


def _ic_check(torch, rows, work):
    """(a): run_classification on the card, launches against the batches,
    3 steps card against CPU, the probe's gradient, one batch's tokens."""
    from audiocodecs_tpu_torch.downstream.cache import TokenCache
    from audiocodecs_tpu_torch.downstream.config import build_codec
    from audiocodecs_tpu_torch.downstream.recipes import classification
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        encode_labels, vocab_spec)
    from audiocodecs_tpu_torch.downstream.recipes.trainer import (
        Trainer, params_to_jax)

    cfg = _downstream_cfg("ic", work)
    batches = _batches_by_split(cfg)
    n = {k: len(v) for k, v in batches.items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = classification.run_classification(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    by_h = lstm_launches_by_hidden()
    epochs = DOWNSTREAM_EPOCHS["ic"]
    encodes = n["train"] + n["valid"] + n["test"]  # each batch once, cached
    probe = epochs * (n["train"] + n["valid"]) + n["test"]
    log(f"downstream IC: {json.dumps(summary)} in {secs:.1f} s; batches "
        f"{n}; B1 launches by width {by_h}, B2 "
        f"{counts['seanet_resblock']}")
    want = {512: 2 * encodes, 128: probe}
    if by_h != want or counts["seanet_resblock"] != 4 * encodes:
        fail(f"downstream IC: expected B1 launches {want} and B2 "
             f"{4 * encodes}, got {by_h} and {counts['seanet_resblock']}")
    _add_launches(rows, "downstream_ic", counts)

    # 3 steps on the card and on the CPU from one init, on the run's cached
    # tokens
    codec = build_codec(cfg, int(cfg["sample_rate"]), mode="encode")
    C = vocab_spec(codec)
    label_map, labels = encode_labels(
        [r for split in batches.values() for b in split for r in b["rows"]],
        cfg["label_field"])
    init = params_to_jax(classification.build_probe_params(
        torch.Generator().manual_seed(0), codec.config.num_codebooks, C,
        int(cfg["embedding_dim_probe"]), int(cfg["probe_hidden"]),
        len(labels), codec_embs=codec.embs()))
    cache = TokenCache(str(work / "ic" / "token_cache.npz"))
    steps = (batches["train"] * 3)[:3]

    def loss_fn(params, batch, generator):
        return classification.classification_loss(params, batch, generator,
                                                  vocab_size=C)

    losses, trained, step_ms = {}, {}, []
    for dev in ("cuda", "cpu"):
        t = Trainer(loss_fn, classification.probe_params_from_jax(init, dev),
                    lr=float(cfg["lr"]), output_folder=str(work / f"ic_{dev}"))
        losses[dev] = []
        for b in steps:
            toks, length = _cached_batch(torch, b, cache, dev)
            label = torch.tensor([label_map[r[cfg["label_field"]]]
                                  for r in b["rows"]], device=dev)
            batch = {"toks": toks, "length": length, "label": label}
            if not losses[dev]:
                # the probe's gradient: the recurrence's backward
                # recomputes through the plain version
                loss, _ = t.compute_loss(batch, None)
                w_hh = t.params["lstm"][0]["w_hh"]
                (g,) = torch.autograd.grad(loss, [w_hh])
                trained[dev, "grad"] = g.detach()
            t1 = time.perf_counter()
            losses[dev].append(t.step(batch, None)[0])
            if dev == "cuda":
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
        trained[dev] = t.params
    log(f"downstream IC 3 steps: card losses {losses['cuda']}, CPU "
        f"{losses['cpu']}; card step ms (host clock, synchronised) "
        f"{[round(v, 2) for v in step_ms]}")
    _hold("downstream IC step losses card-CPU, relative",
          max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"])), 1e-5)
    g, gc = trained["cuda", "grad"], trained["cpu", "grad"]
    if not float(g.abs().max()) > 0:
        fail("downstream IC: the probe's w_hh gradient is zero on the card")
    _hold("downstream IC probe w_hh gradient card-CPU / max", _rel(g, gc),
          1e-4)
    p_card, p_cpu = params_to_jax(trained["cuda"]), params_to_jax(
        trained["cpu"])
    worst = 0.0
    for key in ("embedding", "pool", "head"):
        for k in p_cpu[key]:
            worst = max(worst, _rel(torch.from_numpy(p_card[key][k]),
                                    torch.from_numpy(p_cpu[key][k])))
    for k in p_cpu["lstm"][0]:
        worst = max(worst, _rel(torch.from_numpy(p_card["lstm"][0][k]),
                                torch.from_numpy(p_cpu["lstm"][0][k])))
    _hold("downstream IC params after 3 steps card-CPU / max (worst leaf)",
          worst, 1e-4)

    # one batch's tokens on the card against the CPU codec
    cpu = build_codec(cfg, int(cfg["sample_rate"]), mode="encode",
                      device="cpu")
    b = batches["train"][0]
    toks = codec.sig_to_toks(b["sig"], b["length"]).cpu()
    want_toks = cpu.sig_to_toks(b["sig"], b["length"])
    match = float((toks == want_toks).double().mean())
    log(f"downstream IC batch tokens {tuple(toks.shape)}: token_match "
        f"{match:.6f}")
    if not match >= 0.999:
        fail(f"downstream IC: token_match {match} < 0.999")
    return secs


def _asr_check(torch, rows, work):
    """(b): run_asr on the card, both directions on B1, a finite loss, one
    batch's CTC loss card against CPU."""
    from audiocodecs_tpu_torch.downstream.cache import TokenCache
    from audiocodecs_tpu_torch.downstream.config import build_codec
    from audiocodecs_tpu_torch.downstream.recipes import asr
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        read_split_manifests, vocab_spec)
    from audiocodecs_tpu_torch.downstream.recipes.trainer import (
        Trainer, params_to_jax)
    from audiocodecs_tpu_torch.downstream.text import build_tokenizer

    cfg = _downstream_cfg("asr", work)
    batches = _batches_by_split(cfg)
    n = {k: len(v) for k, v in batches.items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = asr.run_asr(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    by_h = lstm_launches_by_hidden()
    log(f"downstream ASR: {json.dumps(summary)} in {secs:.1f} s; batches "
        f"{n}; B1 launches by width {by_h}, B2 "
        f"{counts['seanet_resblock']}")
    encodes = n["train"] + n["valid"] + n["test"]
    # two directions a forward: train steps, valid WER, test WER and the
    # frequency matrix's pass
    want = {512: 2 * encodes,
            128: 2 * (n["train"] + n["valid"] + 2 * n["test"])}
    if by_h != want:
        fail(f"downstream ASR: expected B1 launches {want}, got {by_h}")
    _add_launches(rows, "downstream_asr", counts)
    log_lines = (work / "asr" / "train_log.txt").read_text().splitlines()
    train_loss = json.loads(log_lines[-1])["train_loss"]
    if not math.isfinite(train_loss):
        fail(f"downstream ASR: train loss {train_loss}")
    log(f"downstream ASR train loss {train_loss}")

    # one batch's CTC loss, card against CPU, from one init
    codec = build_codec(cfg, int(cfg["sample_rate"]), mode="encode")
    C = vocab_spec(codec)
    rows_ = read_split_manifests(cfg)
    tokenizer = build_tokenizer(
        [r["wrd"] for r in rows_["train"]], token_type=cfg["token_type"],
        num_tokens=int(cfg["num_tokens"]),
        character_coverage=float(cfg["character_coverage"]))
    init = params_to_jax(asr.build_asr_params(
        torch.Generator().manual_seed(0), codec.config.num_codebooks, C,
        int(cfg["embedding_dim_probe"]), int(cfg["probe_hidden"]),
        tokenizer.vocab_size, codec_embs=codec.embs()))
    cache = TokenCache(str(work / "asr" / "token_cache.npz"))
    b = batches["train"][0]
    max_label = int(cfg["max_label_len"])
    labels = np.zeros((len(b["ids"]), max_label), np.int64)
    label_pad = np.ones((len(b["ids"]), max_label), np.float32)
    for i, r in enumerate(b["rows"]):
        ids = tokenizer.encode(r["wrd"])[:max_label]
        labels[i, :len(ids)] = ids
        label_pad[i, :len(ids)] = 0.0
    loss, card_batch = {}, None
    for dev in ("cuda", "cpu"):
        toks, length = _cached_batch(torch, b, cache, dev)
        batch = {"toks": toks, "length": length,
                 "labels": torch.from_numpy(labels).to(dev),
                 "label_pad": torch.from_numpy(label_pad).to(dev)}
        card_batch = card_batch or batch
        with torch.no_grad():
            loss[dev] = float(asr.asr_loss(
                asr.asr_params_from_jax(init, dev), batch, None,
                vocab_size=C, blank_id=tokenizer.blank_id)[0])
    # a train step on the card: the CTC recursion forward and backward
    t = Trainer(lambda p, bt, g: asr.asr_loss(
        p, bt, g, vocab_size=C, blank_id=tokenizer.blank_id),
        asr.asr_params_from_jax(init, "cuda"), lr=float(cfg["lr"]),
        output_folder=str(work / "asr_cuda"))
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        t.step(card_batch, None)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"downstream ASR card step ms (host clock, synchronised; "
        f"{tuple(card_batch['toks'].shape)} tokens) "
        f"{[round(v, 2) for v in step_ms]}")
    log(f"downstream ASR one batch's CTC loss: card {loss['cuda']}, CPU "
        f"{loss['cpu']}")
    if not math.isfinite(loss["cuda"]):
        fail("downstream ASR: the CTC loss on the card is not finite")
    _hold("downstream ASR CTC loss card-CPU, relative",
          abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"]), 1e-5)
    return secs


def _llama_check(torch, work):
    """(c): the decoder at slm.yaml's widths, card against CPU."""
    import yaml

    from audiocodecs_tpu_torch.downstream.models import llama

    task = yaml.safe_load(Path("hparams/tasks/slm.yaml").read_text())
    cfg = llama.LlamaConfig(
        vocab_size=1024, num_codebooks=8, hidden_size=task["d_model"],
        num_layers=task["num_layers"], num_heads=task["num_heads"],
        num_kv_heads=task["num_kv_heads"], intermediate_size=task["ffn_dim"],
        max_seq_len=task["max_seq_len"])
    state = llama.init_llama_params(torch.Generator().manual_seed(0), cfg)
    models = {}
    for dev in ("cuda", "cpu"):
        m = llama.Llama(cfg)
        m.load_state_dict(state)
        models[dev] = m.to(dev).eval()
    rng = np.random.default_rng(0)
    frames = 16
    prompt = rng.integers(0, cfg.vocab_size, (2, 1 + frames * 8))
    prompt[:, 0] = cfg.bos_token
    out = {}
    with torch.no_grad():
        for dev, m in models.items():
            toks = torch.from_numpy(prompt).to(dev)
            logits = llama.llama_forward(m, llama.llama_embed(m, toks, cfg),
                                         cfg)
            gen, lengths = llama.llama_generate(m, cfg, toks, LLAMA_GREEDY)
            out[dev] = (logits, gen.cpu(), lengths.cpu())
    _hold("downstream Llama logits card-CPU / max", _rel(out["cuda"][0],
                                                        out["cpu"][0]), 1e-4)
    same = torch.equal(out["cuda"][1], out["cpu"][1]) and torch.equal(
        out["cuda"][2], out["cpu"][2])
    log(f"downstream Llama {LLAMA_GREEDY} greedy tokens card == CPU: {same}")
    if not same:
        fail("downstream Llama: greedy tokens differ on the card and the "
             "CPU")
    # one decode step at position L: the prefill fills the cache first
    m = models["cuda"]
    toks = torch.from_numpy(prompt).cuda()
    L = toks.shape[1]
    with torch.no_grad():
        cache = llama.init_kv_cache(cfg, 2, L + 1, device="cuda")
        llama._run_cached(m, cfg, llama.llama_embed(m, toks, cfg), cache, 0)
        emb = m.embedding.table[toks[:, -1:]]
        step_ms = cuda_ms(torch, lambda: llama._run_cached(m, cfg, emb, cache,
                                                           L), reps=20)
        gen_ms = cuda_ms(torch, lambda: llama.llama_generate(
            m, cfg, toks, LLAMA_GREEDY), reps=3, warmup=1)
    log(f"downstream Llama (d {cfg.hidden_size}, {cfg.num_layers} layers, "
        f"K {cfg.num_codebooks}) at B = 2, prompt {L}: a decode step "
        f"{step_ms:.3f} ms; {LLAMA_GREEDY} greedy tokens {gen_ms:.1f} ms")


def phase_downstream_train(torch, rows):
    """The downstream trainer on the card: the classification probe (IC,
    2 epochs), CTC ASR (BPE, 1 epoch) and the Llama decoder, each against
    the CPU path."""
    work = WORK_DIR / "downstream_train"
    work.mkdir(parents=True, exist_ok=True)
    for label, check in (("IC", lambda: _ic_check(torch, rows, work)),
                         ("ASR", lambda: _asr_check(torch, rows, work)),
                         ("Llama", lambda: _llama_check(torch, work))):
        t0 = time.perf_counter()
        check()
        torch.cuda.empty_cache()
        log(f"downstream {label} seconds: {time.perf_counter() - t0:.1f}")


# SE's encoder at full width (se.yaml's d 256, 4 layers, 4 heads; k 31)
SE_CONFORMER = ("--encoder_type", "conformer")
TASK_STEPS = 3  # train steps held card against CPU, each task
# after them: each leaf's largest card-CPU gap over its largest element,
# and the share of elements within 1e-4 of their leaf's largest
PARAM_GAP, PARAM_MATCH = 2e-3, 0.99999
# the VC cases: (codec yaml, strategy, overrides); BigCodec's kNN-VC needs
# its features and quantized features in one space (``latent: false``)
VC_CASES = (("encodec", "acoustic_splice", ()),
            ("bigcodec", "knn_feats", ("--codec.kwargs.latent", "false")),
            ("bicodec", "global_token_swap", ()))


def _encodec_launches(torch, calls) -> tuple[int, int]:
    """EnCodec-24k's launches for codec calls of the given row counts (an
    encode or a decode each): kernel 1 two layers a call, each in
    ``ceil(rows / max_batch(512))`` serial launches; kernel 2 four a
    call."""
    from audiocodecs_tpu_torch.ops.lstm_recurrence import (
        lstm_recurrence_info)

    most = lstm_recurrence_info(512, 1)["max_batch"]
    return sum(2 * math.ceil(r / most) for r in calls), 4 * len(calls)


def _task_run(torch, rows, work, task, run, calls, extra=()):
    """``run(cfg)`` on the card (the recipe's defaults, ``extra``
    overrides), its kernel launches against ``calls(batches)``: the row
    count of each EnCodec call the run makes."""
    cfg = _downstream_cfg(task, work, extra=extra)
    batches = _batches_by_split(cfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = run(cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    by_h = lstm_launches_by_hidden()
    b1, b2 = _encodec_launches(torch, calls(batches))
    sizes = {k: [len(b["ids"]) for b in v] for k, v in batches.items()}
    log(f"downstream {task.upper()}: {json.dumps(summary)} in {secs:.1f} "
        f"s; batches {sizes}; B1 launches by width {by_h}, B2 "
        f"{counts['seanet_resblock']}")
    if by_h != ({512: b1} if b1 else {}) or counts["seanet_resblock"] != b2:
        fail(f"downstream {task.upper()}: expected B1 launches {{512: {b1}}}"
             f" and B2 {b2}, got {by_h} and {counts['seanet_resblock']}")
    _add_launches(rows, f"downstream_{task}", counts)
    return cfg, batches, summary, secs


def _steps_card_cpu(torch, work, label, make_model, loss_fn, batches, lr):
    """``TASK_STEPS`` Trainer steps of ``make_model(dev)`` from one init
    over ``batches`` (dicts of CPU tensors) on the card and on the CPU. The
    first step's gradients card against CPU within 1e-4 of each leaf's
    largest; the losses within 1e-5 relative; after the steps, each leaf's
    largest gap within ``PARAM_GAP`` of the leaf's largest element, and the
    share of parameter elements within 1e-4 of their leaf's largest
    (``param_match``) at least ``PARAM_MATCH``. Adam moves each element by
    about ``lr · g / (|g| + eps)``, so an element whose gradient is near
    ``eps`` moves by an amount that rounding sets, on either device: hence
    limits above 1e-4. Beside them, what they see of a fault: the CPU's
    last step left out on one leaf at a time, the leaves on which that
    fails the limits. Then one more card step under the profiler: its
    device busy time and idle share beside the steps' median ms. Returns
    the card's model and its step ms."""
    from audiocodecs_tpu_torch.downstream.recipes.trainer import Trainer
    from audiocodecs_tpu_torch.params import flatten_tree

    losses, params, grads, trainers, step_ms = {}, {}, {}, {}, []
    for dev in ("cuda", "cpu"):
        t = Trainer(loss_fn, make_model(dev), lr=lr,
                    output_folder=str(work / f"{label.lower()}_{dev}"))
        first = {k: v.to(dev) for k, v in batches[0].items()}
        loss, _ = t.compute_loss(first, None)
        grads[dev] = [g.detach().cpu() for g in torch.autograd.grad(
            loss, t._leaves)]
        losses[dev] = []
        for i, b in enumerate((batches * TASK_STEPS)[:TASK_STEPS]):
            b = {k: v.to(dev) for k, v in b.items()}
            if dev == "cpu" and i == TASK_STEPS - 1:
                before_last = {k: np.array(v) for k, v in
                               flatten_tree(t.jax_params()).items()}
            if dev == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, _, applied = t.step(b, None)
            if dev == "cuda":
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
            if not applied or not math.isfinite(loss):
                fail(f"downstream {label}: step not applied (loss {loss})")
            losses[dev].append(loss)
        params[dev], trainers[dev] = flatten_tree(t.jax_params()), t
    log(f"downstream {label} {TASK_STEPS} steps: card losses "
        f"{losses['cuda']}, CPU {losses['cpu']}; card step ms (host clock, "
        f"synchronised) {[round(v, 2) for v in step_ms]}")
    _hold(f"downstream {label} first step's gradients card-CPU / max "
          "(worst leaf)", max(_rel(a, b) for a, b in zip(grads["cuda"],
                                                          grads["cpu"])),
          1e-4)
    _hold(f"downstream {label} step losses card-CPU, relative",
          max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"])), 1e-5)

    def gaps(got):
        """Each leaf's (elements off the CPU's by more than 1e-4 of the
        leaf's largest, the largest gap over the leaf's largest)."""
        out = {}
        for k, w in params["cpu"].items():
            top = max(float(np.abs(w).max()), 1e-30)
            gap = np.abs(got[k] - w)
            out[k] = (int((gap > 1e-4 * top).sum()), float(gap.max()) / top)
        return out

    total = sum(w.size for w in params["cpu"].values())
    card, stale = gaps(params["cuda"]), gaps(before_last)
    off = sum(n for n, _ in card.values())
    worst = max(card, key=lambda k: card[k][1])
    most = max(card, key=lambda k: card[k][0])
    share = 1.0 - off / total
    # the fault: the card's leaf k as the CPU's before its last step
    missed = [k for k, (n, r) in stale.items() if r <= PARAM_GAP and
              1.0 - (off - card[k][0] + n) / total >= PARAM_MATCH]
    log(f"downstream {label} params after {TASK_STEPS} steps card-CPU: "
        f"param_match {share:.7f} of {total} elements (most off: {most}, "
        f"{card[most][0]}); worst leaf {worst} {card[worst][1]:.3e}; the "
        f"CPU's last step left out on one leaf fails the limits on "
        f"{len(stale) - len(missed)} of {len(stale)} leaves (the smallest "
        f"such gap {min(r for _, r in stale.values()):.3e}; missed: "
        f"{missed[:8]})")
    _hold(f"downstream {label} params after {TASK_STEPS} steps card-CPU / "
          "max (worst leaf)", card[worst][1], PARAM_GAP)
    if not share >= PARAM_MATCH:
        fail(f"downstream {label}: param_match {share} < {PARAM_MATCH}")
    card = trainers["cuda"]
    first = {k: v.cuda() for k, v in batches[0].items()}
    phase_profile(torch, lambda: card.step(first, None),
                  statistics.median(step_ms), what=f"{label} train step")
    return card.params, step_ms


def _card_twin_on_cpu(torch, card_model, make_model):
    """``make_model("cpu")`` loaded with the card model's weights."""
    cpu = make_model("cpu")
    cpu.load_state_dict({k: v.detach().cpu()
                         for k, v in card_model.state_dict().items()})
    return cpu


def _argmax_match(torch, label, forward, card, cpu, toks):
    """One batch's argmax tokens of the card model against its weights on
    the CPU: token_match ≥ 0.999."""
    with torch.no_grad():
        got = torch.argmax(forward(card, toks.cuda()), -1).cpu()
        want = torch.argmax(forward(cpu, toks), -1)
    match = float((got == want).double().mean())
    log(f"downstream {label} argmax tokens {tuple(got.shape)}: token_match "
        f"{match:.6f}")
    if not match >= 0.999:
        fail(f"downstream {label}: token_match {match} < 0.999")


def _se_check(torch, rows, work):
    """(a) SE with the Conformer."""
    from audiocodecs_tpu_torch.downstream.config import build_codec
    from audiocodecs_tpu_torch.downstream.recipes import se
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        read_field_signals)

    def calls(batches):  # noisy + clean a batch; test twice; decode test
        n = [len(b["ids"]) for split in ("train", "valid", "test", "test")
             for b in batches[split]]
        return [2 * B for B in n] + [len(b["ids"]) for b in batches["test"]]

    cfg, batches, summary, secs = _task_run(
        torch, rows, work, "se", se.run_se, calls, SE_CONFORMER)
    if not 0.0 <= summary["test_TER"] <= 1.0:
        fail(f"downstream SE: test_TER {summary['test_TER']}")
    codec = build_codec(cfg, int(cfg["sample_rate"]), mode="encode")
    K, C = codec.config.num_codebooks, codec.config.vocab_size
    cfg_t = se.encoder_config(cfg)
    state = se.init_token_model(torch.Generator().manual_seed(0), K, C,
                                cfg_t).state_dict()

    def make_model(dev):
        m = se.TokenModel(K, C, cfg_t)
        m.load_state_dict(state)
        return m.to(dev)

    steps = []
    for b in batches["train"]:
        both = np.concatenate([read_field_signals(b, "noisy_wav"),
                               read_field_signals(b, "wav")])
        toks = codec.sig_to_toks(both, np.tile(b["length"], 2)).cpu().clone()
        B = len(b["ids"])
        steps.append({"in_toks": toks[:B], "out_toks": toks[B:],
                      "length": torch.from_numpy(np.asarray(b["length"]))})
    card, step_ms = _steps_card_cpu(
        torch, work, "SE", make_model,
        lambda m, b, g: se.se_loss(m, b, g, vocab_size=C, num_codebooks=K),
        steps, float(cfg["lr"]))

    def forward(m, toks):
        return se.se_forward(m, toks, vocab_size=C, num_codebooks=K)

    _argmax_match(torch, "SE", forward, card,
                  _card_twin_on_cpu(torch, card, make_model),
                  steps[0]["in_toks"])
    return secs, step_ms


def _ss_check(torch, rows, work):
    """(b) SS, 2 speakers."""
    import itertools

    from audiocodecs_tpu_torch.downstream.config import build_codec
    from audiocodecs_tpu_torch.downstream.recipes import se, ss
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        read_field_signals)

    S = 2

    def calls(batches):  # mixture + sources; test twice; S decodes a test
        n = [len(b["ids"]) for split in ("train", "valid", "test", "test")
             for b in batches[split]]
        return [(S + 1) * B for B in n] + [
            len(b["ids"]) for b in batches["test"] for _ in range(S)]

    cfg, batches, summary, secs = _task_run(
        torch, rows, work, "ss", ss.run_ss, calls)
    if not math.isfinite(summary["test_PIT_loss"]):
        fail(f"downstream SS: test_PIT_loss {summary['test_PIT_loss']}")
    codec = build_codec(cfg, int(cfg["sample_rate"]), mode="encode")
    K, C = codec.config.num_codebooks, codec.config.vocab_size
    cfg_t = se.encoder_config({**cfg, "encoder_type": "transformer"})
    shape = (K, C, cfg_t, S * K, ss.head_vocab(C, S))
    state = se.init_token_model(torch.Generator().manual_seed(0),
                                *shape).state_dict()

    def make_model(dev):
        m = se.TokenModel(*shape)
        m.load_state_dict(state)
        return m.to(dev)

    perms = list(itertools.permutations(range(S)))
    steps = []
    for b in batches["train"]:
        stacked = np.concatenate([read_field_signals(b, f) for f in (
            "mix_wav", "wav", "src2_wav")])
        toks = codec.sig_to_toks(stacked,
                                 np.tile(b["length"], S + 1)).cpu().clone()
        B = len(b["ids"])
        steps.append({"mix": toks[:B],
                      "src": toks[B:].reshape(S, B, *toks.shape[1:])
                      .transpose(0, 1),
                      "length": torch.from_numpy(np.asarray(b["length"]))})

    def forward(m, toks):
        return ss.ss_forward(m, toks, vocab_size=C, num_codebooks=K,
                             num_speakers=S)

    card, step_ms = _steps_card_cpu(
        torch, work, "SS", make_model,
        lambda m, b, g: (ss.pit_loss(forward(m, b["mix"]), b["src"],
                                     b["length"], perms), {}),
        steps, float(cfg["lr"]))
    _argmax_match(torch, "SS", forward, card,
                  _card_twin_on_cpu(torch, card, make_model),
                  steps[0]["mix"])
    return secs, step_ms


def _decode_step_ms(torch, model, lcfg, prompt) -> float:
    """One KV-cached decode step of ``model`` after a prefill of
    ``prompt`` [B, L] (CUDA events, median of 20)."""
    from audiocodecs_tpu_torch.downstream.models import llama

    B, L = prompt.shape
    with torch.no_grad():
        cache = llama.init_kv_cache(lcfg, B, L + 1, device="cuda")
        llama._run_cached(model, lcfg, llama.llama_embed(model, prompt,
                                                         lcfg), cache, 0)
        emb = model.embedding.table[prompt[:, -1:].long()]
        return cuda_ms(torch, lambda: llama._run_cached(model, lcfg, emb,
                                                        cache, L), reps=20)


def _greedy_equal(torch, label, card, cpu, lcfg, prompt, n: int):
    """``n`` greedy tokens of the card model and of its weights on the CPU
    from ``prompt``: equal."""
    from audiocodecs_tpu_torch.downstream.models import llama

    got, _ = llama.llama_generate(card, lcfg, prompt.cuda(), n)
    want, _ = llama.llama_generate(cpu, lcfg, prompt, n)
    same = torch.equal(got.cpu(), want)
    log(f"downstream {label} {n} greedy tokens card == CPU: {same}")
    if not same:
        fail(f"downstream {label}: greedy tokens differ on the card and the "
             "CPU")


def _llama_task_check(torch, rows, work, task):
    """(c) SLM or (d) TTS: the run, 3 steps card against CPU on its cached
    tokens, the greedy continuation, a decode step's time."""
    from audiocodecs_tpu_torch.downstream.cache import TokenCache
    from audiocodecs_tpu_torch.downstream.config import build_codec
    from audiocodecs_tpu_torch.downstream.models.llama import (
        Llama, init_llama_params)
    from audiocodecs_tpu_torch.downstream.recipes import slm, tts
    from audiocodecs_tpu_torch.downstream.recipes.common import (
        read_split_manifests)
    from audiocodecs_tpu_torch.downstream.text import build_tokenizer

    def calls(batches):  # each batch encoded once (cached); decode test
        return [len(b["ids"]) for split in ("train", "valid", "test", "test")
                for b in batches[split]]

    run = slm.run_slm if task == "slm" else tts.run_tts
    cfg, batches, summary, secs = _task_run(torch, rows, work, task, run,
                                            calls)
    key = "test_PPL" if task == "slm" else "test_loss"
    if not math.isfinite(summary[key]) or summary["generated"] <= 0:
        fail(f"downstream {task.upper()}: {key} {summary[key]}, generated "
             f"{summary['generated']}")
    codec = build_codec(cfg, int(cfg["sample_rate"]), mode="encode")
    K, C = codec.config.num_codebooks, codec.config.vocab_size
    cache = TokenCache(str(work / task / "token_cache.npz"))
    if task == "slm":
        lcfg = slm.llama_config(cfg, K, C)

        def sequences(b, toks):
            return slm.flatten_with_specials(
                toks, b["length"], lcfg.bos_token, lcfg.eos_token,
                lcfg.pad_token, int(cfg["max_flat_len"]))
    else:
        tok = build_tokenizer(
            [r["wrd"] for r in read_split_manifests(cfg)["train"]],
            token_type=cfg.get("token_type", "char"),
            num_tokens=int(cfg.get("num_tokens", 1000)),
            character_coverage=float(cfg.get("character_coverage", 1.0)))
        lcfg = slm.llama_config(cfg, K, C, num_special=3 + tok.vocab_size)

        def sequences(b, toks):
            return tts.build_sequences(
                toks, b["length"], [tok.encode(r["wrd"]) for r in b["rows"]],
                lcfg, int(cfg["max_text_len"]), int(cfg["max_flat_len"]))
    state = init_llama_params(torch.Generator().manual_seed(0), lcfg)
    slm.seed_embeddings(state, codec.embs(), K, C)

    def make_model(dev):
        m = Llama(lcfg)
        m.load_state_dict(state)
        return m.to(dev)

    steps = []
    for b in batches["train"]:
        toks = cache.get_batch(b["ids"])
        if toks is None:
            fail(f"downstream {task.upper()}: a batch is missing from its "
                 "cache")
        flat, mask = sequences(b, toks)
        steps.append({"flat": torch.from_numpy(flat),
                      "mask": torch.from_numpy(mask)})
    label = task.upper()
    card, step_ms = _steps_card_cpu(
        torch, work, label, make_model,
        lambda m, b, g: (slm.next_token_nll(m, b["flat"], b["mask"], lcfg),
                         {}), steps, float(cfg["lr"]))
    cpu = _card_twin_on_cpu(torch, card, make_model)
    flat = steps[0]["flat"]
    L = flat.shape[1]
    prompt_len = ((min(L // 2, 64) // K) * K + 1 if task == "slm"
                  else tts.text_prompt_len(int(cfg["max_text_len"]), K) + 1)
    prompt = flat[:, :prompt_len]
    _greedy_equal(torch, label, card, cpu, lcfg, prompt,
                  int(cfg["gen_frames"]) * K)
    step = _decode_step_ms(torch, card, lcfg, prompt.cuda())
    log(f"downstream {label} decoder (d {lcfg.hidden_size}, "
        f"{lcfg.num_layers} layers, K {K}) at B = {prompt.shape[0]}, prompt "
        f"{prompt_len}: a decode step {step:.3f} ms")
    return secs, step_ms


def _vc_pair_ms(torch, codec, strategy, cfg) -> float:
    """The first pair's conversion (``vc.convert_pair``, the waveform back
    on the host) on the card codec: median ms of 3 after a warm call."""
    from audiocodecs_tpu_torch.downstream.datasets.manifest import (
        read_manifest)
    from audiocodecs_tpu_torch.downstream.recipes import vc
    from audiocodecs_tpu_torch.utils.audio import read_wav

    src_row, ref_row = vc.vc_pairs(read_manifest(cfg["test_csv"]))[0]
    src, ref = read_wav(src_row["wav"])[0], read_wav(ref_row["wav"])[0]
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vc.convert_pair(codec, strategy, src, ref, int(cfg["topk"]))[0].cpu()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def _recording_grids(torch, grids: list):
    """Within the block, every token grid the port's codecs make
    (``sig_to_toks``) or decode (``toks_to_sig``) is appended to
    ``grids`` as a CPU tensor."""
    from audiocodecs_tpu_torch import codec as codec_mod

    enc, dec = codec_mod.Codec.sig_to_toks, codec_mod.Codec.toks_to_sig

    def sig_to_toks(self, *a, **kw):
        out = enc(self, *a, **kw)
        grids.append(out.cpu().clone())
        return out

    def toks_to_sig(self, toks, *a, **kw):
        grids.append(torch.as_tensor(toks).cpu().clone())
        return dec(self, toks, *a, **kw)

    codec_mod.Codec.sig_to_toks = sig_to_toks
    codec_mod.Codec.toks_to_sig = toks_to_sig
    try:
        yield
    finally:
        codec_mod.Codec.sig_to_toks, codec_mod.Codec.toks_to_sig = enc, dec


def _vc_check(torch, rows, work):
    """(e) VC on EnCodec-24k, BigCodec-16k and BiCodec-16k, 2 pairs each:
    ``run_vc`` on the card, its launches against the pairs, then each
    pair's conversion on the card codec's weights on the CPU: every token
    grid equal and each converted waveform within 1e-4 of max|sig|."""
    from audiocodecs_tpu_torch.downstream import config as config_mod
    from audiocodecs_tpu_torch.downstream.datasets.manifest import (
        read_manifest)
    from audiocodecs_tpu_torch.downstream.recipes import vc
    from audiocodecs_tpu_torch.utils import audio

    build, write = config_mod.build_codec, audio.write_wav
    for name, strategy, extra in VC_CASES:
        grids, wavs, built = {"cuda": [], "cpu": []}, [], []

        def build_card(cfg_, sr, mode="reconstruct", device=None):
            built.append(build(cfg_, sr, mode, device))
            return built[-1]

        def write_wav(path, sig, *a, **kw):
            wavs.append(np.array(sig))
            return write(path, sig, *a, **kw)

        cfg = _downstream_cfg("vc", work, codec=name,
                              extra=("--max_pairs", "2", *extra),
                              out=f"vc_{name}")
        config_mod.build_codec, audio.write_wav = build_card, write_wav
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with _recording_grids(torch, grids["cuda"]):
                summary = vc.run_vc(cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            config_mod.build_codec, audio.write_wav = build, write
        counts, by_h = read_counts(), lstm_launches_by_hidden()
        card = built[0]
        pair_ms = _vc_pair_ms(torch, card, strategy, cfg)
        pairs = summary["pairs"]
        if summary["strategy"] != strategy or pairs != 2:
            fail(f"downstream VC {name}: {summary}")
        # per pair: EnCodec 2 encodes + 1 decode (B = 1); BigCodec 2
        # encodes and a decode, 2 wide LSTM layers each, the decoder's 9
        # units; BiCodec its decoder's 6 units
        want = {"encodec": ({512: 2 * 3 * pairs}, 4 * 3 * pairs, 0),
                "bigcodec": ({1536: 2 * 3 * pairs}, 0, 9 * pairs),
                "bicodec": ({}, 0, 6 * pairs)}[name]
        got = (by_h, counts["seanet_resblock"], counts["dac_resunit"])
        log(f"downstream VC {name} ({strategy}): {json.dumps(summary)} in "
            f"{secs:.1f} s (the codec's build and the battery included); a "
            f"pair's conversion {pair_ms:.2f} ms (host clock, synchronised, "
            f"median of 3); B1 by width {by_h}, B2 {got[1]}, B4 {got[2]}")
        if got != want:
            fail(f"downstream VC {name}: expected launches (B1, B2, B4) "
                 f"{want}, got {got}")
        _add_launches(rows, f"downstream_vc_{name}", counts)

        # the pairs again on the CPU, on the card codec's weights
        spec = dict(cfg["codec"])
        spec["kwargs"] = {**spec.get("kwargs", {}), "state_dict": {
            k: v.detach().cpu() for k, v in card.state_dict().items()}}
        del built[:], card
        torch.cuda.empty_cache()
        cpu = build({**cfg, "codec": spec}, int(cfg["sample_rate"]),
                    device="cpu")
        t0 = time.perf_counter()
        outs = []
        with _recording_grids(torch, grids["cpu"]):
            for src_row, ref_row in vc.vc_pairs(
                    read_manifest(cfg["test_csv"]))[:pairs]:
                src = audio.read_wav(src_row["wav"])[0]
                ref = audio.read_wav(ref_row["wav"])[0]
                outs.append(vc.convert_pair(cpu, strategy, src, ref,
                                            int(cfg["topk"]))[0].numpy())
        cpu_s = time.perf_counter() - t0
        del cpu
        toks_c, toks_h = grids["cuda"], grids["cpu"]
        if len(toks_c) != len(toks_h) or not all(
                torch.equal(a, b) for a, b in zip(toks_c, toks_h)):
            fail(f"downstream VC {name}: token grids differ on the card and "
                 "the CPU")
        log(f"downstream VC {name}: {len(toks_c)} token grids equal; CPU "
            f"conversions {cpu_s:.1f} s")
        if len(wavs) != len(outs) or any(a.shape != b.shape
                                         for a, b in zip(wavs, outs)):
            fail(f"downstream VC {name}: converted waveforms' shapes differ")
        _hold(f"downstream VC {name} converted waveforms card-CPU / max|sig|",
              max(float(np.abs(a - b).max()) / float(np.abs(b).max())
                  for a, b in zip(wavs, outs)), 1e-4)


def phase_downstream_tasks(torch, rows):
    """The rest of the downstream recipes on the card, each against the CPU
    path: SE with the Conformer, SS, SLM and TTS (1 epoch each, then 3
    steps card against CPU), and VC on three codecs."""
    work = WORK_DIR / "downstream_tasks"
    work.mkdir(parents=True, exist_ok=True)
    times = {}
    for label, check in (
            ("SE", lambda: _se_check(torch, rows, work)),
            ("SS", lambda: _ss_check(torch, rows, work)),
            ("SLM", lambda: _llama_task_check(torch, rows, work, "slm")),
            ("TTS", lambda: _llama_task_check(torch, rows, work, "tts")),
            ("VC", lambda: _vc_check(torch, rows, work))):
        t0 = time.perf_counter()
        check()
        torch.cuda.empty_cache()
        times[label] = time.perf_counter() - t0
        log(f"downstream {label} seconds: {times[label]:.1f}")


# the SLM decoder of hparams/tasks/slm.yaml over EnCodec-24k's 8 codebooks
SLM_WIDTHS = dict(vocab_size=1024, num_codebooks=8, hidden_size=256,
                  num_layers=4, num_heads=4, num_kv_heads=2,
                  intermediate_size=688)
PARALLEL_SLM_B, PARALLEL_SLM_L = 4, 512  # rows, flat tokens (max_flat_len)


def _leaf_gaps(got: dict, want: dict, label: str) -> None:
    """Each leaf of ``got`` within 1e-5 of the leaf's largest element of
    ``want``."""
    by_leaf = {}
    for k, w in want.items():
        w = w.detach().double().cpu()
        top = max(float(w.abs().max()), 1e-30)
        gap = (got[k].detach().double().cpu() - w).abs()
        by_leaf[k] = float(gap.max()) / top
    worst = max(by_leaf, key=by_leaf.get)
    log(f"{label} params after the steps, sharded vs one-device: worst leaf "
        f"{worst} {by_leaf[worst]:.3e} of its largest, over "
        f"{len(by_leaf)} leaves")
    _hold(f"{label} params (worst leaf, of its largest)", by_leaf[worst],
          1e-5)


def _parallel_codec(torch, rows, mesh, card):
    """Two sharded codec steps against two one-device steps on the same
    EnCodec-24k weights; the sharded run's launches counted. Returns the
    one-device model (for serving)."""
    from audiocodecs_tpu_torch.models.encodec import Encodec
    from audiocodecs_tpu_torch.parallel.train import shard_codec_params

    sr = 24000
    ref = Encodec(sr, sr, num_codebooks=8, device="cuda",
                  generator=torch.Generator().manual_seed(0))
    twin = Encodec(sr, sr, num_codebooks=8, device="cuda",
                   state_dict=ref.state_dict())
    sharded = shard_codec_params(twin, mesh)
    batches = _train_batches(np.random.default_rng(0), TRAIN_B, 1.0, sr, 2)
    losses, ms = {}, {}
    # cuDNN's deterministic algorithms on both runs: its default weight
    # gradients sum in an order that varies from call to call
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    for label, model in (("one-device", ref), ("sharded", sharded)):
        state, step = _trainer(torch, model)
        losses[label], ms[label] = [], []
        if label == "sharded":
            reset_counts()
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step(state, b)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
            losses[label].append(float(met["loss"]))
        if label == "sharded":
            counts = read_counts()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags
    log(f"parallel codec step EnCodec-24k B={TRAIN_B} x 1 s ({card}): "
        f"losses sharded {losses['sharded']} one-device "
        f"{losses['one-device']}; ms a step (host clock, synchronised) "
        f"sharded {[round(v, 3) for v in ms['sharded']]} one-device "
        f"{[round(v, 3) for v in ms['one-device']]}; launches "
        f"{json.dumps(counts)}")
    if counts != _launch_table(8, 16):
        fail(f"parallel codec step: expected 4 B1 and 8 B2 launches a step "
             f"over 2 steps, got {counts}")
    _add_launches(rows, "parallel_codec_step", counts)
    _hold("parallel codec step losses sharded vs one-device, relative",
          max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"],
                                                  losses["one-device"])),
          1e-6)
    _leaf_gaps(dict(sharded.full_module().named_parameters()),
               dict(ref.named_parameters()), "parallel codec step")
    return ref


def _parallel_serving(torch, rows, mesh, codec, card):
    """Data-parallel serving against the one-device path."""
    from audiocodecs_tpu_torch.parallel.mesh import data_parallel

    sig = _noise(np.random.default_rng(7), [(TRAIN_B, 24000)])[0]
    with torch.no_grad():
        toks = codec.sig_to_toks(sig)
        rec = codec.toks_to_sig(toks)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks_dp = data_parallel(codec.sig_to_toks, mesh, sig)
        rec_dp = data_parallel(codec.toks_to_sig, mesh, toks_dp)
        torch.cuda.synchronize()
        dp_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
    gap = float((rec_dp - rec).abs().max()) / max(float(rec.abs().max()),
                                                  1e-30)
    log(f"parallel dp serving EnCodec-24k B={TRAIN_B} x 1 s ({card}): "
        f"tokens equal {bool(torch.equal(toks_dp, toks))}; waveform "
        f"{gap:.3e} of max; roundtrip {dp_ms:.3f} ms (host clock); launches "
        f"{json.dumps(counts)}")
    if not torch.equal(toks_dp, toks):
        fail("parallel dp serving: tokens differ from the one-device path")
    _hold("parallel dp serving waveform / max", gap, 1e-5)
    if counts != _launch_table(4, 8):
        fail(f"parallel dp serving: expected 4 B1 and 8 B2 launches, got "
             f"{counts}")
    _add_launches(rows, "parallel_dp_serving", counts)


def _slm_batch(torch, lcfg):
    """B rows of L K-interleaved tokens, ragged: BOS, content, EOS, pad,
    the loss mask over content and EOS."""
    rng = np.random.default_rng(3)
    B, L = PARALLEL_SLM_B, PARALLEL_SLM_L
    flat = rng.integers(0, lcfg.vocab_size, (B, L))
    mask = np.zeros((B, L), np.float32)
    for b in range(B):
        n = L - 1 - 37 * b
        flat[b, 0], flat[b, n] = lcfg.bos_token, lcfg.eos_token
        flat[b, n + 1:] = lcfg.pad_token
        mask[b, 1:n + 1] = 1.0
    return (torch.as_tensor(flat, device="cuda"),
            torch.as_tensor(mask, device="cuda"))


def _parallel_slm(torch, mesh, card):
    """Each sharded SLM step against the unsharded one from one init:
    Megatron (mp = 1, remat on), GPipe (S = 1, M = 2) and the expert-
    parallel 4-expert MoE decoder."""
    import copy
    import dataclasses

    from audiocodecs_tpu_torch.downstream.models.llama import (
        Llama, LlamaConfig, init_llama_params)
    from audiocodecs_tpu_torch.parallel.moe import shard_moe_llama_params
    from audiocodecs_tpu_torch.parallel.pipeline import (
        make_pp_slm_train_step, shard_pp_llama_params,
        stack_pipeline_stages)
    from audiocodecs_tpu_torch.parallel.train import (
        make_slm_train_step, shard_llama_params)
    from audiocodecs_tpu_torch.params import to_jax_params

    base = LlamaConfig(**SLM_WIDTHS)
    flat, mask = _slm_batch(torch, base)

    def pipeline(model, lcfg):
        stage = shard_pp_llama_params(stack_pipeline_stages(
            to_jax_params(model.state_dict(), model), 1), mesh, lcfg,
            device="cuda")
        step, _ = make_pp_slm_train_step(
            lcfg, torch.optim.Adam(stage.parameters(), 1e-3), mesh, 2)
        return stage, lambda f, m: step(stage, f, m)

    def step_of(model):
        return model, make_slm_train_step(
            model, torch.optim.Adam(model.parameters(), 1e-3))

    cases = (
        ("Megatron mp=1, remat", dataclasses.replace(base, remat=True),
         lambda m, c: step_of(shard_llama_params(m, mesh))),
        ("GPipe S=1 M=2", base, pipeline),
        ("switch-MoE 4 experts, expert-parallel", dataclasses.replace(
            base, moe_experts=4),
         lambda m, c: step_of(shard_moe_llama_params(m, mesh))))
    for label, lcfg, make in cases:
        # the one-device reference without remat (it changes no number)
        ref = Llama(dataclasses.replace(lcfg, remat=False))
        ref.load_state_dict(init_llama_params(
            torch.Generator().manual_seed(11), lcfg))
        ref = ref.cuda()
        twin = copy.deepcopy(ref)
        twin.cfg = lcfg
        holder, step = make(twin, lcfg)
        _, ref_step = step_of(ref)
        losses, ms, grads = {"sharded": [], "one-device": []}, [], {}
        for i in range(2):
            for which, fn in (("one-device", ref_step), ("sharded", step)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses[which].append(float(fn(flat, mask)))
                torch.cuda.synchronize()
                if which == "sharded":
                    ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                want = {k: p.grad.detach().clone()
                        for k, p in ref.named_parameters()}
                got = {k[len("local."):]: p.grad.detach().clone()
                       for k, p in holder.named_parameters()}
        worst = max(_rel(got[k], want[k]) for k in want)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"],
                                                      losses["one-device"]))
        log(f"parallel SLM {label} at slm.yaml's widths B={flat.shape[0]} "
            f"L={flat.shape[1]} ({card}): losses sharded "
            f"{losses['sharded']} one-device {losses['one-device']}; "
            f"sharded ms a step (host clock, synchronised) "
            f"{[round(v, 3) for v in ms]}")
        _hold(f"parallel SLM {label} losses, relative", rel, 1e-6)
        _hold(f"parallel SLM {label} first-step gradients / max (worst "
              f"leaf)", worst, 1e-5)


def phase_parallel(torch, rows, card):
    """The parallel layer at world size 1 over NCCL: the sharded codec step
    and data-parallel serving (kernels 1 and 2 counted), the Megatron,
    GPipe and expert-parallel SLM steps at ``slm.yaml``'s widths, each
    against its one-device twin; then the multichip dry run on 4 CPU
    ranks over gloo."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from audiocodecs_tpu_torch.parallel.dryrun import dryrun_multichip
    from audiocodecs_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh)

    tmp = tempfile.mkdtemp()
    init_distributed("cuda", init_method=f"file://{tmp}/store",
                     world_size=1, rank=0)
    try:
        mesh = make_mesh(1, model_parallel=1, device="cuda")
        log(f"parallel mesh: {mesh} backend {dist.get_backend()}")
        codec = _parallel_codec(torch, rows, mesh, card)
        _parallel_serving(torch, rows, mesh, codec, card)
        _parallel_slm(torch, mesh, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line = dryrun_multichip(4, device="cpu")
    log(f"parallel dryrun on 4 CPU ranks (gloo): {line} "
        f"({time.perf_counter() - t0:.1f} s)")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs the port on a GPU")
    try:
        import audiocodecs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"audiocodecs_tpu_torch not importable ({e}); run from the root "
             "of the repository")
    t0 = time.perf_counter()

    def timed(phase, *args):
        t1 = time.perf_counter()
        out = phase(torch, *args)
        log(f"{phase.__name__} seconds: {time.perf_counter() - t1:.1f}")
        return out

    name, card, peaks = phase_card(torch)
    prefetch_checkpoints()
    phase_build()
    rows = [*timed(phase_lstm, peaks), timed(phase_resblock, peaks),
            timed(phase_packed, peaks), timed(phase_dac_resunit, peaks),
            *timed(phase_dac_resunit_forms, peaks),
            # B2's one-pass rows, filled by phase_resblock_default
            *({"name": name, "launches": 0} for name in B2_FORMS)]
    for phase in (phase_main_path, phase_dac_path, phase_speechtokenizer,
                  phase_encodec_stream, phase_mimi, phase_wavtokenizer,
                  phase_encodec_vocos, phase_encodec_48k, phase_past,
                  phase_bigcodec, phase_dac_tiers, phase_bigcodec_tier,
                  phase_server):
        timed(phase, rows)
    timed(phase_train, rows, card)
    timed(phase_resblock_default, peaks, rows)
    for phase in (phase_seanet_tiers, phase_certify, phase_audiodec,
                  phase_hilcodec, phase_nanocodec, phase_xcodec2,
                  phase_stablecodec, phase_magicodec, phase_zoo_one_pass,
                  phase_wavlm_kmeans, phase_dycast, phase_focalcodec,
                  phase_bicodec, phase_semanticodec,
                  phase_checkpoint_loading, phase_zoo_loading,
                  phase_long_audio, phase_sweep_sr, phase_metric_models,
                  phase_downstream_train, phase_downstream_tasks):
        timed(phase, rows)
    timed(phase_parallel, rows, card)
    log(f"total seconds: {time.perf_counter() - t0:.1f}")
    log(json.dumps({"kernels": rows}))
    log(f"card: {card}")
    if "jax" in sys.modules or any(
            m == "audiocodecs_tpu" or m.startswith("audiocodecs_tpu.")
            for m in sys.modules):
        fail("the port pulled in jax or audiocodecs_tpu")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
