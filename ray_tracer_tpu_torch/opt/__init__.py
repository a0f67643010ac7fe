"""Inverse rendering: the fit loop and its checkpoints."""
