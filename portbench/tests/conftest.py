"""The benchmark's own tests (outside the repository's ``tests/``): its
harness and yardsticks on the CPU, and the comparisons held to the port at
small sizes.  ``python -m pytest portbench/tests`` from the root of the
checkout."""
import sys
from pathlib import Path

import pytest
import torch

PORTBENCH = Path(__file__).resolve().parents[1]
REPO = PORTBENCH.parent
for p in (str(REPO / "src"), str(PORTBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
# a few threads a test worker: several workers share the machine's cores
torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
