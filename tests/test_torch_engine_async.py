"""The port's ``BatchingEngine.step_async`` (event-driven admission with
chunked prefill accounting) against the JAX package's, on the scenarios of
tests/test_torch_engine.py: identical token logs and per-step
``page_stats()``."""
import pytest
import torch

from test_torch_engine import CASES, check_engine, models  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("scenario,paged", CASES)
def test_engine_step_async_matches_reference(models, scenario, paged):
    check_engine(models, scenario, paged, "step_async")
