"""A module-scoped autouse fixture for the port's heavy test files: torch
on two threads while the module runs. The tier-1 run puts six test files
at once on one machine's cores, and the port's decodes run small ops,
which torch spreads over every core to no gain (the paper model's bf16
prewarm ran ~4x faster on two threads than on every core of a loaded
machine). Import it into a test module to use it:

    from tests.torch_threads import two_torch_threads  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
