"""Downstream tasks: the speech-resynthesis (SR) evaluation — configs,
corpora, the bucketed loader, the metric battery and ``recipes.sr`` — and
the trainer with its classification and CTC ASR recipes over cached
codec tokens."""
