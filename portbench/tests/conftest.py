"""The benchmark's CPU tests: the port's wrappers take their plain
versions on CPU tensors, so a cell runs end to end at a small size."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    """A few threads: the CPU is shared with other tests' workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)
