"""Transfer throughput model."""
