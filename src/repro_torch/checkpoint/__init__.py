"""Atomic local checkpoints and carbon-aware mirroring."""
