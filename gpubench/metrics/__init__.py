"""The per-metric readers; each file is found by its metric's name."""
