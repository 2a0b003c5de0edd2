import os

import pytest

# smoke tests and benches must see the real (1-device) platform; ONLY the
# dry-run sets xla_force_host_platform_device_count (see launch/dryrun.py)
os.environ.setdefault("JAX_ENABLE_X64", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "soak: long seeded fault-injection soak — excluded from tier-1; "
        "opt in with RUN_SOAK=1 (scripts/check.sh runs it under "
        "CHECK_BENCH=1)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's hand-written kernels have no "
        "CPU mode); skips without one")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RUN_SOAK") == "1":
        return
    skip_soak = pytest.mark.skip(reason="soak test — set RUN_SOAK=1")
    for item in items:
        if "soak" in item.keywords:
            item.add_marker(skip_soak)

# hypothesis is optional (requirements-dev.txt): without it the property
# tests importorskip themselves, and the rest of the suite must still run.
try:
    from hypothesis import settings, HealthCheck
except ModuleNotFoundError:
    pass
else:
    settings.register_profile(
        "repro",
        deadline=None,
        max_examples=25,
        suppress_health_check=[HealthCheck.too_slow],
    )
    settings.load_profile("repro")
