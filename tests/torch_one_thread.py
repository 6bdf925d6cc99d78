"""A fixture for the port's test modules: their torch work on one
intra-op thread."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Run the module's torch work on one intra-op thread, and restore the
    setting after it. The plain versions step thousands of small tensor
    ops; with the suite's parallel workers each holding a full thread
    pool, the pools' fork-join waits on descheduled threads (on an
    8-core CPU, a 256x128 v3 frame took 227 s in each of six 8-thread
    processes run at once, 2.8 s in six 1-thread ones)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
