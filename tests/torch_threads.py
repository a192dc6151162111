"""One torch thread for each test module of the port that imports this
fixture (`from torch_threads import one_torch_thread`), restored after the
module: the suite runs six workers on the box's cores, and each worker at
torch's default thread count would contend with the others."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
