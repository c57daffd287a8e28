"""Signal metrics."""
