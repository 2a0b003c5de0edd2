"""Metrics registry (plan_batch timing and cell counts)."""
