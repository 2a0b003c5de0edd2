def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's hand-written kernels have no "
        "CPU mode); skips without one")
