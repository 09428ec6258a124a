"""Shared by the port's training tests: the one-thread fixture and a view
of a module's gradients as its weights.

A test file takes the fixture by importing it
(``from torch_train_support import one_torch_thread  # noqa: F401``);
pytest finds a fixture among a module's names, and ``autouse`` applies
it to every test of that file.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a file trains: tier-1 runs a worker per
    core, and torch's default thread pool in each worker oversubscribes
    the CPU (on an 8-core CPU, six copies of the CNN canary at once took
    651 s with the default threads, 18 s with one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class GradView:
    """A stand-in module whose weights are ``net``'s gradients (for the
    ``*_params_to_flax`` bridges, which read ``.weight`` / ``.bias``)."""

    def __init__(self, net):
        self._net = net

    def __getattr__(self, name):
        value = getattr(self._net, name)
        if isinstance(value, torch.nn.Parameter):
            return value.grad
        if isinstance(value, torch.nn.ModuleList):
            return [GradView(m) for m in value]
        if isinstance(value, torch.nn.Module):
            return GradView(value)
        return value
