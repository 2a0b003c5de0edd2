"""Cluster model of the PyTorch/CUDA port (sites, pods, zones)."""
