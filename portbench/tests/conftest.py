"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
root of the checkout. Tests marked `cuda` need a card and skip without one;
on the card they run with `python -m pytest portbench/tests -q -m cuda`."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# A cell at a size the CPU runs in seconds: the program's plain versions of
# its kernels, the same harness, the same check.
SMALL = ["platform=cpu", "num_envs=8", "training.batch_size=32", "training.start=64",
         "reinforcement.actor.hidden_size=32", "reinforcement.critic.hidden_size=32",
         "memory.size=20000"]
