import os
import sys

# tests run single-device unless a test spawns its own subprocess with
# --xla_force_host_platform_device_count (per the assignment: never set the
# device-count flag globally).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Offline CI images may lack hypothesis; fall back to the deterministic
# stub under tests/_compat so the property tests still collect and run
# (see requirements-dev.txt for the real dev dependencies).
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_compat"))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
