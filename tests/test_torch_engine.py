"""Port serving engine against the JAX package's ``BatchingEngine``: the
same prompts, tenants and weights (reduced smollm-135m, fp32, JAX init
carried across) must give identical token logs, through ``step`` and
``step_async``, in the dense and the paged layout; paged engines must also
report equal ``page_stats()`` after every step (all keys but ``scrub_ms``,
a wall-clock reading). Scenarios cover mixed prompt lengths across two
tenants, a shared-prefix pair that takes copy-on-write, a pool small
enough to preempt, and the int8 KV cache (``kv_quant``).

Token logs are compared exactly. The premise is asserted, not assumed: one
teacher-forced JAX forward over each prompt plus its output shows a top-2
logit margin above 1e-3 at every generated position, far above the fp32
drift between the two implementations (see tests/test_torch_models.py).
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

# name -> (engine kwargs, [(prompt len, seed, tenant, max_new_tokens)], quant)
SCENARIOS = {
    "mixed": (dict(n_slots=3, max_len=64),
              [(n, n, "ab"[i % 2], 6)
               for i, n in enumerate((2, 5, 15, 16, 17, 31, 33))], False),
    "cow": (dict(n_slots=2, max_len=64),
            [(34, 7, "t", 2), (34, 7, "t", 8)], False),
    "preempt": (dict(n_slots=4, max_len=64, cache_pages=5),
                [(20, i, "t", 20) for i in range(4)], False),
    "kv_quant": (dict(n_slots=2, max_len=64),
                 [(n, 100 + n, "q", 5) for n in (5, 17, 23)], True),
}

# (scenario, paged); tests/test_torch_engine_async.py runs the same
# comparison through step_async
CASES = [("mixed", False), ("mixed", True), ("cow", True), ("preempt", True),
         ("kv_quant", False), ("kv_quant", True)]


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=n).tolist()


def _serve(engine, spec, vocab, mode):
    reqs = [engine.submit(_prompt(vocab, n, seed), max_new_tokens=new,
                          tenant=tenant) for n, seed, tenant, new in spec]
    stats = []
    for _ in range(2000):
        if mode == "step":
            engine.step()
        else:
            engine.step_async(prefill_chunk=4)
        s = engine.page_stats()
        s.pop("scrub_ms", None)
        stats.append(s)
        if engine.idle():
            break
    assert engine.idle()
    return [r.out_tokens for r in reqs], stats


def check_engine(models, scenario, paged, mode):
    jcfg, jparams, cfg, params = models
    kw, spec, quant = SCENARIOS[scenario]
    jmodel = j_get_model(jcfg.replace(kv_quant=quant))
    model = Model(cfg.replace(kv_quant=quant), device="cpu")
    if paged:
        kw = dict(kw, paged=True, page_size=16)
    else:
        kw = {k: v for k, v in kw.items() if k != "cache_pages"}
    vocab = cfg.vocab_size
    j_logs, j_stats = _serve(JEngine(jmodel, jparams, **kw), spec, vocab,
                             mode)
    t_eng = BatchingEngine(model, params, **kw)
    t_logs, t_stats = _serve(t_eng, spec, vocab, mode)
    assert_margins(jmodel, jparams,
                   [_prompt(vocab, n, seed) for n, seed, _, _ in spec],
                   j_logs, kw["max_len"])
    assert t_logs == j_logs
    assert t_stats == j_stats
    if scenario == "cow":
        assert t_stats[-1]["cow_copies"] >= 1
        assert t_stats[-1]["prefix_hits"] >= 3
    if scenario == "preempt":
        assert t_eng.preemptions > 0


@pytest.mark.parametrize("scenario,paged", CASES)
def test_engine_step_matches_reference(models, scenario, paged):
    check_engine(models, scenario, paged, "step")
