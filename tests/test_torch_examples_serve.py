"""The port's serving examples on the CPU against the reference's
(``examples/{quickstart,multi_tenant,serve_baas}.py``), each run in this
process with its prints captured:

- ``quickstart_torch.py``: the inventory, the vSlice, the core's output
  shape, the Table III forecast, the BAaaS services and result, the final
  utilization;
- ``serve_baas_torch.py`` on the reference example's weights (its
  ``PRNGKey(0)`` init carried over): every request's token head and
  finish reason, the engine steps and ``page_stats()``;
- ``multi_tenant_torch.py`` on the same weights: the shell's booleans,
  the gateway's sessions, quota refusal, tenant stats and audit, the
  fleet's placement, hand-off record and final device states.

What each prints equals the reference's but for times and rates
(``examples_parity.mask``); ``main``'s results agree with what it printed.
Without a card the examples' CUDA default raises.
"""
import jax
import numpy as np
import pytest
import torch

from examples_parity import captured, mask, port_example, reference_main

torch.set_num_threads(1)

EXAMPLES = ("quickstart", "serve_baas", "multi_tenant", "train_smollm")


@pytest.fixture(scope="module")
def carried():
    """The reference examples' served weights (reduced smollm-135m, fp32,
    ``PRNGKey(0)``) as the port's tensors."""
    from repro.configs import get_config, reduced
    from repro.models import get_model
    from repro_torch.interop import params_from_numpy
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    jp = get_model(cfg).init(jax.random.PRNGKey(0))
    return lambda: params_from_numpy(jax.tree.map(np.asarray, jp), cfg)


def test_quickstart_prints_the_reference():
    res, got = captured(port_example("quickstart").main, ["--device", "cpu"])
    want = reference_main("quickstart")
    assert mask(got) == mask(want)
    assert res["out_shape"] == (64, 16, 16)
    assert res["invoke"] == (2 * np.arange(8)).tolist()
    assert res["services"] == ["vector-double"]


def test_serve_baas_prints_the_reference(carried):
    res, got = captured(port_example("serve_baas").main,
                        ["--device", "cpu"], params=carried())
    want = reference_main("serve_baas")
    assert mask(got) == mask(want)
    assert len(res["streams"]) == 8 and res["total_new"] == 96
    # requests 0 and 1 share their prompt (copy-on-write prefix pages)
    assert res["streams"][0] == res["streams"][1]
    assert f"page pool: {res['page_stats']}" in got


def test_multi_tenant_prints_the_reference(carried):
    res, got = captured(port_example("multi_tenant").main,
                        ["--device", "cpu"], params=carried())
    want = reference_main("multi_tenant")
    assert mask(got) == mask(want)
    assert res["tenant0_unchanged"] and res["slot2_axpy"]
    assert res["gateway"]["audited"] == 9
    assert res["fleet"]["served"] == 5
    assert res["fleet"]["handoff"][0] == "hot"
    assert all(len(s) == 12 for s in res["fleet"]["streams"].values())


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there "
                    "(tests/test_torch_cuda.py::test_port_example_on_card)")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_example(name).main([])
