"""Downstream evaluation: the speech-resynthesis (SR) path — configs,
corpora, the bucketed loader, the signal-metric battery and
``recipes.sr``."""
