"""Step-0 training gradients of every family against the JAX package
(ARCH_IDS[:5]; the other half in test_torch_train_step_b.py, so that
the two run on two test workers). Reduced configs in fp32, the JAX init
carried across; loss, xent and aux within rtol 1e-5, every gradient leaf
within rtol 1e-4 / atol 1e-5 x its max |g| (tests/torch_parity.py::
check_step0_gradients). A MoE config first asserts that the reference's
router has a top-k margin above 1e-5 at every token, so that no near-tie
can route the two packages apart.
"""
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from torch_parity import check_step0_gradients

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCH_IDS[:5])
def test_step0_gradients_match_reference(arch, monkeypatch):
    check_step0_gradients(arch, monkeypatch)
