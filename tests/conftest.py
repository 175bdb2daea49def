import os

# keep tests on the single real CPU device; the dry-run subprocess sets its
# own XLA_FLAGS (512 fake devices) — never set that globally here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (subprocess dry-run)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips (inside the test) without one")
    _register_hypothesis_profiles()

def _register_hypothesis_profiles():
    # deterministic hypothesis runs by default: fixed derivation seed, no
    # deadline (CI machines jitter), examples printed as reproducible blobs.
    # The scheduler-fuzz CI job opts into a bigger randomized budget with
    # HYPOTHESIS_PROFILE=ci-fuzz; its falsifying examples land in the
    # .hypothesis example database (uploaded as a CI artifact).
    try:
        from hypothesis import settings
    except ImportError:     # hypothesis is a soft dep (requirements-dev.txt)
        return
    settings.register_profile("repro", deadline=None, derandomize=True,
                              print_blob=True)
    settings.register_profile("ci-fuzz", deadline=None, derandomize=False,
                              max_examples=200, print_blob=True)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "repro"))
