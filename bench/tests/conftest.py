"""The benchmark's CPU tests: `python -m pytest -q bench/tests` from the
root of the repo (the repo's own `pytest.ini` collects `tests/` only).
The root and `src/` go on the path, so `bench` and the program import."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
