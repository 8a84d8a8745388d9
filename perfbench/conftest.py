"""The benchmark's CPU tests run their cells as the benchmark's own
process does, with one intra-op thread, so that several test workers on
one machine do not starve each other's timed windows."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
