"""Evaluation recipes: speech resynthesis (``sr``) and its shared battery."""
