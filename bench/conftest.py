"""Shared set-up of the benchmark's own tests (CPU, small sizes)."""

import pytest

# the traffic of each mix cut to a size a CPU test run holds; the first
# requests in flight of the review loop already serve every recording
TINY = {
    "review": dict(recordings=2, patients=2, record_s=3, seizure_s=[0.5, 1],
                   train_record_s=[1, 1.5, 0.5], in_flight=2, compare_recordings=2),
    "onboard": dict(recordings=2, record_s=30, seizures=3, seizure_s=[1, 3], epochs=3,
                    warmup_jobs=1, compare_jobs=2),
}
SEED = 2**31 + 977


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark's cells run only there)")
    return "cuda:0"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the driver runs several test processes
    side by side, and the small tensors here gain nothing from more."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
