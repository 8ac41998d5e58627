"""tests/test_runtime.py's three engine cases on the port, dense and paged,
with the port's token logs held equal to the JAX engine's (reduced
smollm-135m, fp32, the JAX init carried across): continuous batching
returns the tokens of a dedicated single-request decode, an empty prompt
is refused up front, and one batched prefill of a slot gives exactly the
tokens of the legacy one-decode-per-prompt-token path. The premise of
exact token comparison is asserted (tests/torch_parity.py::
assert_margins).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import get_model as j_get_model
from repro.runtime import BatchingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine
from torch_parity import assert_margins

torch.set_num_threads(1)

PAGED = dict(paged=True, page_size=16)


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return jmodel, jparams, Model(cfg, device="cpu"), params


def _serve(engine, prompts, new):
    reqs = [engine.submit(p, max_new_tokens=new) for p in prompts]
    assert engine.run_until_idle()
    assert all(len(r.out_tokens) == new for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("paged", [False, True])
def test_batching_engine_matches_single_stream(models, paged):
    """Continuous batching returns the same greedy tokens as a dedicated
    single-request decode (the port's prefill + decode), and as the JAX
    engine. The reference test's third prompt, [9, 9, 9, 4], leaves a
    top-2 margin of 2e-4 at one generated position under these weights,
    below the 1e-3 premise of an exact comparison across the packages;
    [9, 8, 9, 4] takes its place."""
    jmodel, jparams, model, params = models
    prompts = [np.array([3, 5, 7]), np.array([11, 2]),
               np.array([9, 8, 9, 4])]

    def solo(prompt, n=5):
        toks = torch.tensor(prompt, dtype=torch.int32)[None]
        _, caches = model.prefill(params, {"tokens": toks[:, :-1]}, 64) \
            if toks.shape[1] > 1 else (None, model.make_caches(1, 64))
        tok = toks[:, -1:]
        pos = torch.tensor([toks.shape[1] - 1], dtype=torch.int32)
        out = []
        for _ in range(n):
            logits, caches = model.decode(params, caches, tok, pos)
            tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
            pos = pos + 1
        return out

    kw = dict(n_slots=2, max_len=64, **(PAGED if paged else {}))
    expected = [solo(p) for p in prompts]
    got = _serve(BatchingEngine(model, params, **kw), prompts, 5)
    ref = _serve(JEngine(jmodel, jparams, **kw), prompts, 5)
    assert_margins(jmodel, jparams, prompts, ref, 16)
    assert got == expected == ref


@pytest.mark.parametrize("paged", [False, True])
def test_engine_rejects_empty_prompt(models, paged):
    """A zero-length prompt is refused up front with a clear error, on
    both packages, and leaves the engine idle."""
    jmodel, jparams, model, params = models
    kw = dict(n_slots=2, max_len=64, **(PAGED if paged else {}))
    for engine in (BatchingEngine(model, params, **kw),
                   JEngine(jmodel, jparams, **kw)):
        with pytest.raises(ValueError, match="empty prompt"):
            engine.submit([], max_new_tokens=4)
        with pytest.raises(ValueError, match="empty prompt"):
            engine.submit(np.zeros((0,), np.int32))
        assert engine.idle()


@pytest.mark.parametrize("paged", [False, True])
def test_batched_prefill_matches_legacy_token_loop(models, paged):
    """Prefilling a slot with one batched prefill call gives exactly the
    tokens of the old one-full-batch-decode-per-prompt-token path; prompt
    lengths straddle the pad-bucket boundaries (8, 16). The port's logs
    equal the JAX engine's in both modes."""
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).tolist()
               for n in (5, 8, 9, 13, 17)]
    kw = dict(n_slots=2, max_len=64, **(PAGED if paged else {}))
    logs = {}
    for mode in ("batched", "legacy"):
        logs[mode] = _serve(BatchingEngine(model, params, prefill_mode=mode,
                                           **kw), prompts, 6)
        logs["jax_" + mode] = _serve(JEngine(jmodel, jparams,
                                             prefill_mode=mode, **kw),
                                     prompts, 6)
    assert_margins(jmodel, jparams, prompts, logs["jax_batched"], 24)
    assert logs["batched"] == logs["legacy"] == logs["jax_batched"] \
        == logs["jax_legacy"]
