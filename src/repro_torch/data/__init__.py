"""The training data pipeline."""
