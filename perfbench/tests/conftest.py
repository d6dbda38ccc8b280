"""The CPU tests run windows of a few seconds: a traced one traces its
last second, where the card's runs trace their last eight. Each test's
torch ops run on one thread, so that workers running side by side do not
crowd each other's loops out of their windows."""
import pytest
import torch


@pytest.fixture(autouse=True)
def short_traced_span(monkeypatch):
    from perfbench import trace
    monkeypatch.setattr(trace, "SPAN_SECONDS", 1.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
