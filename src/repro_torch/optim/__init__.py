"""Optimizer, schedule and the carbon-adaptive cross-pod sync."""
