"""The reference's paged-pool and engine-lifecycle tests
(``tests/test_paged.py``) on the port, on the CPU, with the same
assertions: the five ``PagePoolManager`` cases (``tests/test_paged.py``
:33-95) and the nine engine cases the engine parity suite
(``tests/test_torch_engine.py``) does not cover — the int8 pool against
dense int8, copy-on-write branches, queueing on page exhaustion, a
tenant's page budget, the impossible-request refusal, the stall signal,
cancel in flight and queued, and finish reason EOS. (Paged vs dense is in
``tests/test_torch_engine.py``; the gateway and fleet page cases are in
``tests/test_torch_fleet.py``.)

Parity: the EOS case's and the copy-on-write case's token logs equal the
JAX package's ``BatchingEngine`` on the same prompts.

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``).
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
from repro_torch.runtime.paged import PagePoolManager

torch.set_num_threads(1)

DEV = "cpu"


@pytest.fixture(scope="module")
def jax_model():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def served_model(jax_model):
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_model[1]), cfg)
    return cfg, Model(cfg, device=DEV), params


def _prompt(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=n).tolist()


# ---------------------------------------------------------------------------
# PagePoolManager (pure host control plane)
# ---------------------------------------------------------------------------

def test_pool_alloc_free_refcount():
    pool = PagePoolManager(n_pages=9, page_size=4, n_slots=2, max_blocks=8)
    assert pool.total_pages == 8 and pool.free_pages == 8
    plan = pool.admit(0, "a", list(range(10)))       # 3 blocks (pos 0..9)
    assert len(plan.blocks) == 3 and plan.write_start == 0
    assert pool.used_pages == 3 and pool.tenant_pages("a") == 3
    assert list(pool.block_tables[0][:3]) == plan.blocks
    pool.release_slot(0)
    assert pool.used_pages == 0 and pool.tenant_pages("a") == 0
    assert pool.block_tables[0].sum() == 0


def test_pool_prefix_share_and_cow():
    pool = PagePoolManager(n_pages=17, page_size=4, n_slots=3, max_blocks=8)
    toks = list(range(11))                           # 2 full blocks + tail
    a = pool.admit(0, "t", toks)
    b = pool.admit(1, "t", toks)
    # b shares a's 2 full blocks AND the exact-content tail page
    assert b.matched_pages == 3 and b.skip_prefill
    assert b.blocks == a.blocks
    assert pool.used_pages == 3                      # one physical copy
    # write into the shared tail forces a COW detach for the writer
    assert pool.is_shared(0, 2)
    src, dst = pool.cow(0, 2, "t")
    assert src == a.blocks[2] and dst != src
    assert not pool.is_shared(0, 2) and pool.cow_copies == 1
    # a context differing only in its FINAL token still shares the tail:
    # position n-1 is written by decode, not prefill, so written content
    # is identical
    c = pool.admit(2, "t", toks[:-1] + [99])
    assert c.matched_pages == 3 and c.skip_prefill
    # ...but a context differing at a WRITTEN tail position shares only
    # the full blocks
    pool.release_slot(2)
    d = pool.admit(2, "t", toks[:-2] + [99, 10])
    assert d.matched_pages == 2 and not d.skip_prefill
    assert d.blocks[:2] == a.blocks[:2] and d.blocks[2] not in (src, dst)


def test_pool_sharing_is_tenant_scoped():
    pool = PagePoolManager(n_pages=17, page_size=4, n_slots=2, max_blocks=8)
    toks = list(range(9))
    a = pool.admit(0, "alice", toks)
    b = pool.admit(1, "bob", toks)
    assert b.matched_pages == 0
    assert not set(a.blocks) & set(b.blocks)
    assert pool.tenant_pages("alice") == 3 and pool.tenant_pages("bob") == 3


def test_pool_admit_exhaustion_rolls_back_cleanly():
    """admit() hitting NoPagesError mid-allocation must free the pages it
    already popped (and undo shared increfs) — no silent pool shrink."""
    from repro_torch.runtime.paged import NoPagesError
    pool = PagePoolManager(n_pages=5, page_size=4, n_slots=2, max_blocks=8)
    pool.admit(0, "t", list(range(7)))               # 2 of 4 pages
    free_before = pool.free_pages
    with pytest.raises(NoPagesError):
        pool.admit(1, "u", list(range(10)))          # needs 3, only 2 free
    assert pool.free_pages == free_before
    assert pool.tenant_pages("u") == 0


def test_pool_pages_needed_counts_sharing():
    pool = PagePoolManager(n_pages=17, page_size=4, n_slots=2, max_blocks=8)
    toks = list(range(11))
    assert pool.pages_needed("t", toks) == 3
    pool.admit(0, "t", toks)
    assert pool.pages_needed("t", toks) == 0         # fully shareable now
    assert pool.pages_needed("t", toks, share=False) == 3
    assert pool.pages_needed("other", toks) == 3


# ---------------------------------------------------------------------------
# Engine cases
# ---------------------------------------------------------------------------

def test_paged_engine_int8_pool_matches_dense_int8(served_model):
    """kv_quant engines agree paged-vs-dense (int8 pools + scales page)."""
    cfg, model, params = served_model
    qcfg = cfg.replace(kv_quant=True)
    qmodel = Model(qcfg, device=DEV)
    prompts = [_prompt(cfg, n, seed=100 + n) for n in (5, 17, 23)]

    def serve(**kw):
        eng = BatchingEngine(qmodel, params, n_slots=2, max_len=64, **kw)
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        assert eng.run_until_idle() is True
        return [r.out_tokens for r in reqs]

    assert serve() == serve(paged=True, page_size=16)


def test_cow_branches_decode_independently(served_model):
    """Two branches share prompt pages; after one finishes, the survivor
    keeps decoding correct tokens (COW detached its tail page)."""
    cfg, model, params = served_model
    prompt = _prompt(cfg, 34, seed=7)      # 2 full blocks + 1-token tail

    eng = BatchingEngine(model, params, n_slots=2, max_len=64, paged=True,
                        page_size=16)
    short = eng.submit(prompt, max_new_tokens=2, tenant="t")
    long = eng.submit(prompt, max_new_tokens=8, tenant="t")
    assert eng.run_until_idle() is True
    assert eng.pool.stats()["prefix_hits"] >= 3      # 2 full + tail shared
    assert eng.pool.stats()["cow_copies"] >= 1

    solo = BatchingEngine(model, params, n_slots=1, max_len=64)
    ref = solo.submit(prompt, max_new_tokens=8)
    solo.run_until_idle()
    assert long.out_tokens == ref.out_tokens
    assert short.out_tokens == ref.out_tokens[:2]
    # all pages returned once both branches finished
    assert eng.pool.used_pages == 0


def test_page_exhaustion_queues_not_oom(served_model):
    """A pool smaller than the offered load defers admissions (and preempts
    when growth fails) instead of erroring — every request completes."""
    cfg, model, params = served_model
    eng = BatchingEngine(model, params, n_slots=4, max_len=64, paged=True,
                        page_size=16, cache_pages=5)      # 4 usable pages
    reqs = [eng.submit(_prompt(cfg, 20, seed=i), max_new_tokens=20)
            for i in range(4)]
    assert eng.run_until_idle(max_steps=5000) is True
    assert all(len(r.out_tokens) == 20 for r in reqs)
    assert all(r.finish_reason == "length" for r in reqs)


def test_tenant_page_budget_queues(served_model):
    """A tenant at its page budget queues while another tenant's requests
    flow — per-tenant accounting of the shared memory fabric."""
    cfg, model, params = served_model
    eng = BatchingEngine(model, params, n_slots=4, max_len=64, paged=True,
                        page_size=16, cache_pages=17)
    eng.set_tenant_pages("greedy", 2)
    g1 = eng.submit(_prompt(cfg, 20, seed=1), max_new_tokens=4,
                    tenant="greedy")     # needs 2 pages: fills the budget
    g2 = eng.submit(_prompt(cfg, 20, seed=2), max_new_tokens=4,
                    tenant="greedy")     # must wait for g1's pages
    other = eng.submit(_prompt(cfg, 20, seed=3), max_new_tokens=4,
                       tenant="other")
    eng.step()
    assert eng.active_by_tenant() == {"greedy": 1, "other": 1}
    assert eng.queued_by_tenant() == {"greedy": 1}
    assert eng.run_until_idle() is True
    assert all(len(r.out_tokens) == 4 for r in (g1, g2, other))


def test_submit_rejects_impossible_request(served_model):
    cfg, model, params = served_model
    eng = BatchingEngine(model, params, n_slots=2, max_len=64, paged=True,
                        page_size=16, cache_pages=3)      # 2 usable pages
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(_prompt(cfg, 40, seed=0), max_new_tokens=20)
    # a big pool doesn't help when the BLOCK TABLE can't hold the context:
    # this must reject at submit, not explode inside step() (regression)
    eng2 = BatchingEngine(model, params, n_slots=2, max_len=64, paged=True,
                         page_size=16, cache_pages=33)    # 32 usable pages
    with pytest.raises(ValueError, match="blocks"):
        eng2.submit(_prompt(cfg, 70, seed=0), max_new_tokens=4)
    ok = eng2.submit(_prompt(cfg, 10, seed=1), max_new_tokens=4)
    assert eng2.run_until_idle() is True
    assert len(ok.out_tokens) == 4


# ---------------------------------------------------------------------------
# Engine lifecycle satellites
# ---------------------------------------------------------------------------

def test_run_until_idle_signals_stall(served_model):
    """max_steps expiring with queued work returns False — a stall is not
    silently mistaken for completion."""
    cfg, model, params = served_model
    eng = BatchingEngine(model, params, n_slots=2, max_len=64)
    for i in range(3):
        eng.submit(_prompt(cfg, 5, seed=i), max_new_tokens=8)
    assert eng.run_until_idle(max_steps=2) is False
    assert eng.run_until_idle() is True


def test_cancel_in_flight_frees_slot_and_pages(served_model):
    """cancel() releases an in-flight request's slot and pool pages
    immediately (a timed-out client must not burn a slot until
    max_new_tokens) and stamps finish_reason."""
    cfg, model, params = served_model
    eng = BatchingEngine(model, params, n_slots=2, max_len=64, paged=True,
                        page_size=16)
    victim = eng.submit(_prompt(cfg, 17, seed=0), max_new_tokens=40)
    other = eng.submit(_prompt(cfg, 5, seed=1), max_new_tokens=4)
    for _ in range(2):
        eng.step()
    assert victim in eng.inflight()
    pages_before = eng.pool.used_pages
    assert eng.cancel(victim) is True
    assert victim.done.is_set() and victim.finish_reason == "cancelled"
    assert victim not in eng.inflight()
    assert eng.pool.used_pages < pages_before
    assert eng.cancel(victim) is False               # already finished
    assert eng.run_until_idle() is True
    assert other.finish_reason == "length"


def test_cancel_queued_request(served_model):
    cfg, model, params = served_model
    eng = BatchingEngine(model, params, n_slots=1, max_len=64)
    first = eng.submit(_prompt(cfg, 5, seed=0), max_new_tokens=3)
    queued = eng.submit(_prompt(cfg, 5, seed=1), max_new_tokens=3)
    assert eng.cancel(queued) is True
    assert queued.finish_reason == "cancelled" and not queued.out_tokens
    assert eng.run_until_idle() is True
    assert first.finish_reason == "length"
    assert eng.queued_by_tenant() == {}              # pruned, not zeroed


def test_finish_reason_eos(served_model):
    cfg, model, params = served_model
    eng = BatchingEngine(model, params, n_slots=1, max_len=64)
    probe = eng.submit(_prompt(cfg, 6, seed=2), max_new_tokens=8)
    eng.run_until_idle()
    eos = probe.out_tokens[0]
    eng2 = BatchingEngine(model, params, n_slots=1, max_len=64, eos_id=eos)
    req = eng2.submit(_prompt(cfg, 6, seed=2), max_new_tokens=8)
    eng2.run_until_idle()
    assert req.finish_reason == "eos"
    assert req.out_tokens == [eos]




# ---------------------------------------------------------------------------
# Parity with the JAX package's engine
# ---------------------------------------------------------------------------

def _serve_both(served_model, jax_model, engine_kw, spec, eos_probe=False):
    """Run the same submissions through the port's engine and the JAX
    package's; returns both token logs and finish reasons."""
    cfg, model, params = served_model
    jmodel, jparams = jax_model
    logs = []
    for Engine, m, p in ((BatchingEngine, model, params),
                         (JEngine, jmodel, jparams)):
        kw = dict(engine_kw)
        if eos_probe:
            probe = Engine(m, p, n_slots=1, max_len=64)
            r = probe.submit(_prompt(cfg, 6, seed=2), max_new_tokens=8)
            probe.run_until_idle()
            kw["eos_id"] = r.out_tokens[0]
        eng = Engine(m, p, **kw)
        reqs = [eng.submit(_prompt(cfg, n, seed=s), max_new_tokens=new,
                           tenant=t) for n, s, t, new in spec]
        assert eng.run_until_idle(max_steps=5000) is True
        logs.append([(r.out_tokens, r.finish_reason) for r in reqs])
    return logs


@pytest.mark.parametrize("case", ["cow", "exhaustion", "eos"])
def test_token_logs_equal_reference(served_model, jax_model, case):
    """The copy-on-write branches, the exhausted pool (admission deferred,
    growth preempting) and the EOS stop give the JAX package's token logs
    and finish reasons; the top-2 margin premise is asserted."""
    from torch_parity import assert_margins
    cfg = served_model[0]
    engine_kw, spec, eos = {
        "cow": (dict(n_slots=2, max_len=64, paged=True, page_size=16),
                [(34, 7, "t", 2), (34, 7, "t", 8)], False),
        "exhaustion": (dict(n_slots=4, max_len=64, paged=True,
                            page_size=16, cache_pages=5),
                       [(20, i, "t", 20) for i in range(4)], False),
        "eos": (dict(n_slots=1, max_len=64),
                [(6, 2, "t", 8)], True),
    }[case]
    got, ref = _serve_both(served_model, jax_model, engine_kw, spec, eos)
    assert got == ref
    if case == "eos":
        assert ref[0][1] == "eos" and len(ref[0][0]) == 1
    prompts = [_prompt(cfg, n, seed=s) for n, s, _, _ in spec]
    assert_margins(*jax_model, prompts, [out for out, _ in ref], 64)
