"""The benchmark's checks of a routed model, collected with the port's
tests: every test of ``portbench/tests/test_portbench_routes.py`` (the
reference following the program's own choices of experts, the route gap
and miss share, ``RouteCapture``, the routing faults the check fails, the
dense numbers and the expert leaves) runs here as it does there, on two
threads, as the port's other CPU tests of whole steps do."""
import pytest
import torch

from portbench.tests.test_portbench_routes import *  # noqa: F401,F403


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
