"""The prefill as the reference's compiled program on the port, on the CPU.

On the card the engine's prefill is one CUDA graph a pad bucket
(``runtime/serve.py``'s ``PrefillProgram``), and a graph's outputs live at
fixed addresses: the prefill fills one batch-1 cache tree the program owns,
reset in place at every call. Here:

* a prefill into a reused tree dirtied by garbage equals a prefill into a
  new tree, bit for bit, at every bucket from 8 to ``max_len``: plain GQA,
  a windowed ring (gemma3), ``clamp_window=False``, MLA, MoE and int8 KV;
  and its hidden states and caches equal the JAX package's
  ``make_prefill_step`` within the reference's tolerances;
* the engine, whose prefill now fills the shared program's tree, gives the
  JAX engine's token logs, ``page_stats()`` and pool invariants, lockstep
  and ``step_async`` with two admissions of one bucket pending at once
  (the margin premise asserted as in ``tests/torch_parity.py``);
* the program cache: one program a (model, max_len, layout), shared by
  two engines, at most ``PREFILL_PROGRAMS``, closed on eviction; the graph
  cap of a program (``GraphProgram(max_graphs=...)``, least recently used
  dropped) over a windowed engine's prompt lengths;
* ``GreedyLoop``, the SSM models' serve loop: every cache leaf and step
  buffer keeps its address through 32 steps (mamba2, zamba2 reduced), and
  its tokens are the reference's.

Tolerances: atol 2e-5, rtol 2e-4 on fp32 values where the two packages
run the same algorithm; int8 K/V within one quantization step.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import get_model as j_get_model
from repro.runtime import BatchingEngine as JEngine
from repro.runtime.serve import make_prefill_step as j_make_prefill_step
from repro.runtime.serve import make_serve_step as j_make_serve_step
from repro_torch.configs import get_config, reduced
from repro_torch.core import graphs
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.runtime import (BatchingEngine, GreedyLoop,
                                 clear_prefill_programs, make_prefill_step,
                                 prefill_program)
from repro_torch.runtime import serve as tserve
from repro_torch.tree import flatten
from torch_parity import assert_margins, greedy, with_norms_near_one

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)
MAX_LEN = 64
BUCKETS = (8, 16, 32, 64)

# name -> (arch, config replacements, clamp_window)
CASES = {
    "gqa": ("smollm-135m", {}, True),
    "ring": ("gemma3-1b", dict(window=16), True),
    "ring_full_len": ("gemma3-1b", dict(window=16), False),
    "mla": ("deepseek-v2-lite-16b", {}, True),
    "moe": ("qwen3-moe-30b-a3b", {}, True),
    "int8": ("smollm-135m", dict(kv_quant=True), True),
}


def _pair(arch, replace):
    """The reduced config in fp32 on both sides, the JAX init carried
    across (MLA ``kv_norm`` near 1)."""
    kw = dict(dtype="float32", **replace)
    jmodel = j_get_model(j_reduced(j_get_config(arch)).replace(**kw))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tree = with_norms_near_one(tree, np.random.default_rng(0))
    cfg = reduced(get_config(arch)).replace(**kw)
    return (jmodel, jax.tree.map(jnp.asarray, tree),
            Model(cfg, device="cpu"), params_from_numpy(tree, cfg))


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(case):
        arch, replace, _ = CASES[case]
        key = (arch, tuple(sorted(replace.items())))
        if key not in cache:
            cache[key] = _pair(arch, replace)
        return cache[key]

    return get


def _tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n)) \
        .astype(np.int32)


def _dirty(caches, seed):
    """Fill every leaf of a cache tree with garbage, in place."""
    gen = torch.Generator().manual_seed(seed)
    for leaf in graphs._leaves(caches):
        if leaf.dtype.is_floating_point:
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 7)
        else:
            leaf.copy_(torch.randint(-50, 50, leaf.shape, generator=gen))


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_into_a_dirty_tree_equals_a_new_one(pairs, case, bucket):
    """The prefill resets the tree it is given to ``init_cache``'s values
    and fills it in place: the same leaves (addresses), bit for bit the
    leaves and hidden states of a prefill into a new tree."""
    clamp = CASES[case][2]
    _, _, model, params = pairs(case)
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, bucket, bucket))
    tree = model.make_prefill_caches(1, MAX_LEN, clamp_window=clamp)
    ptrs = [t.data_ptr() for t in graphs._leaves(tree)]
    for seed in range(2):                       # dirty, then reused again
        _dirty(tree, seed)
        h, got = model.prefill(params, {"tokens": toks}, MAX_LEN,
                               clamp_window=clamp, caches=tree)
        want_h, want = model.prefill(params, {"tokens": toks}, MAX_LEN,
                                     clamp_window=clamp)
        assert [t.data_ptr() for t in graphs._leaves(got)] == ptrs
        assert torch.equal(h, want_h)
        for g, w in zip(graphs._leaves(got), graphs._leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_into_a_reused_tree_matches_the_reference(pairs, case):
    """Hidden states and every cache leaf of the port's prefill into a
    reused tree against the JAX package's ``make_prefill_step``."""
    clamp = CASES[case][2]
    jmodel, jparams, model, params = pairs(case)
    toks = _tokens(model.cfg.vocab_size, 24, 5)
    step = make_prefill_step(model, MAX_LEN, clamp_window=clamp)
    tree = model.make_prefill_caches(1, MAX_LEN, clamp_window=clamp)
    step(params, {"tokens": torch.from_numpy(
        _tokens(model.cfg.vocab_size, 40, 6))}, caches=tree)
    h, got = step(params, {"tokens": torch.from_numpy(toks)}, caches=tree)
    jh, jc = j_make_prefill_step(jmodel, MAX_LEN, clamp_window=clamp)(
        jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    want, _ = flatten(jax.tree.map(np.asarray, jc))
    mine, _ = flatten(got)
    assert len(mine) == len(want)
    for g, w in zip(mine, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1
        elif np.issubdtype(g.dtype, np.integer):
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# The engine on the shared prefill program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smollm():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return j_get_model(jcfg), jparams, Model(cfg, device="cpu"), params


# two prompts of bucket 32 (contexts 19 and 24) admitted together, then
# shorter and longer ones: (length, seed, tenant, new tokens)
SPEC = [(20, 1, "a", 6), (25, 2, "b", 6), (9, 3, "a", 5), (40, 4, "b", 4),
        (30, 5, "a", 5)]


def _run(engine, mode, vocab):
    reqs = [engine.submit(np.random.default_rng(seed).integers(
        0, vocab, size=n).tolist(), max_new_tokens=new, tenant=tenant)
        for n, seed, tenant, new in SPEC]
    stats, pending = [], []
    for _ in range(2000):
        if mode == "step":
            engine.step()
        else:
            engine.step_async(prefill_chunk=4)
            pending.append(sorted(
                engine._pad_ctx(engine._ctx_tokens(engine._slots[i])[:-1])
                .shape[1] for i in engine._prefilling))
        s = engine.page_stats()
        s.pop("scrub_ms", None)
        stats.append(s)
        if engine.paged and hasattr(engine.pool, "verify"):
            engine.pool.verify()
        if engine.idle():
            break
    assert engine.idle()
    return [r.out_tokens for r in reqs], stats, pending


@pytest.mark.parametrize("mode", ["step", "step_async"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_on_the_prefill_program_matches_reference(smollm, paged,
                                                         mode):
    """Token logs and per-step ``page_stats()`` equal the JAX engine's; in
    ``step_async`` the two bucket-32 admissions are pending at once, each
    holding a copy of the program's caches (the second prefill rewrote
    them before the first was spliced)."""
    jmodel, jparams, model, params = smollm
    kw = dict(n_slots=3, max_len=MAX_LEN)
    if paged:
        kw.update(paged=True, page_size=16)
    vocab = model.cfg.vocab_size
    logs, stats, pending = _run(BatchingEngine(model, params, **kw), mode,
                                vocab)
    want, want_stats, _ = _run(JEngine(jmodel, jparams, **kw), mode, vocab)
    assert logs == want
    assert stats == want_stats
    if mode == "step_async":
        assert any(p.count(32) >= 2 for p in pending)
    assert_margins(jmodel, jparams,
                   [np.random.default_rng(seed).integers(0, vocab, size=n)
                    .tolist() for n, seed, _, _ in SPEC], want, MAX_LEN)


def test_pending_prefill_keeps_a_copy(smollm):
    """A prefill buffered by ``step_async`` holds no tensor of the
    program's own tree."""
    _, _, model, params = smollm
    eng = BatchingEngine(model, params, n_slots=3, max_len=MAX_LEN)
    for n, seed, tenant, new in SPEC[:2]:
        eng.submit(np.random.default_rng(seed).integers(
            0, model.cfg.vocab_size, size=n).tolist(), max_new_tokens=new,
            tenant=tenant)
    eng.step_async(prefill_chunk=4)
    assert len(eng._prefilling) == 2
    owned = {t.data_ptr() for t in graphs._leaves(eng._prefill_fn.caches)}
    for pending in eng._prefilling.values():
        assert not owned & {t.data_ptr() for t in
                            graphs._leaves(pending.buf)}


def test_program_cache_shares_bounds_and_closes(smollm):
    """One program a (model, max_len, layout), shared by two engines; at
    most ``PREFILL_PROGRAMS``, the least recently asked for evicted and
    closed (its caches freed; a later call makes them anew)."""
    _, _, model, params = smollm
    clear_prefill_programs()
    a = BatchingEngine(model, params, n_slots=2, max_len=MAX_LEN)
    b = BatchingEngine(model, params, n_slots=2, max_len=MAX_LEN)
    p = BatchingEngine(model, params, n_slots=2, max_len=MAX_LEN,
                       paged=True, page_size=16)
    assert a._prefill_fn is b._prefill_fn is prefill_program(model, MAX_LEN)
    assert p._prefill_fn is prefill_program(model, MAX_LEN, full_len=True)
    assert p._prefill_fn is not a._prefill_fn
    first = a._prefill_fn
    first(params, np.zeros((1, 8), np.int32))
    assert first.caches is not None
    n = tserve.PREFILL_PROGRAMS
    progs = [prefill_program(model, MAX_LEN + 16 * i) for i in range(1, n - 1)]
    assert len(tserve._prefill_programs) == n
    assert first.caches is not None             # still cached
    prefill_program(model, MAX_LEN + 16 * (n - 1))
    assert len(tserve._prefill_programs) == n
    assert first.caches is None                 # evicted, closed
    assert prefill_program(model, MAX_LEN, full_len=True) is p._prefill_fn
    assert all(prefill_program(model, MAX_LEN + 16 * i) is progs[i - 1]
               for i in range(1, n - 1))
    h, caches = first(params, np.zeros((1, 16), np.int32))
    assert first.caches is caches and h.shape[1] == 16
    clear_prefill_programs()
    assert not tserve._prefill_programs


class _FakeCapture(graphs.GraphProgram):
    """A graph program whose capture records nothing and whose replay
    returns the outputs of the eager first call: the bookkeeping of keys,
    replays and the cap without a card (value-keyed arguments only)."""

    def __init__(self, fn, max_graphs):
        super().__init__(fn, "cuda:0", max_graphs=max_graphs)

    def _capture(self, g, call_args, placed, kinds):
        g.graph = types.SimpleNamespace(replay=lambda: None)
        g.outputs = ("graph", call_args)
        self._pool.live += 1
        self.captures += 1


def test_graph_cap_drops_the_least_recently_used():
    """``max_graphs``: a capture past the cap drops the least recently
    called graph (counted); a replay refreshes its graph; a dropped key
    captures again."""
    prog = _FakeCapture(lambda n: ("eager", n), max_graphs=3)
    assert [prog(n)[0] for n in (1, 2, 3)] == ["eager"] * 3
    assert prog(1) == ("graph", (1,))             # replay: 1 most recent
    prog(4)                                       # drops 2
    assert prog.counts() == dict(graphs=3, captures=4, replays=1,
                                 evictions=1)
    assert prog(2)[0] == "eager"                  # captured again, drops 3
    assert prog(1)[0] == "graph" and prog(4)[0] == "graph"
    assert prog.counts() == dict(graphs=3, captures=5, replays=3,
                                 evictions=2)
    assert prog._pool.live == 3
    with pytest.raises(ValueError, match="max_graphs"):
        graphs.GraphProgram(lambda: None, "cuda:0", max_graphs=0)


def test_windowed_engine_graphs_stay_under_the_cap(monkeypatch):
    """A dense engine with a windowed layer pads a prompt past the window
    to its own length (the reference's padding), so its prompt lengths
    are unbounded; its prefill program is built with the cap, and a
    program at the cap keeps ``PREFILL_GRAPHS`` graphs over them."""
    cfg = reduced(get_config("gemma3-1b")).replace(dtype="float32",
                                                   window=16)
    eng = BatchingEngine(Model(cfg, device="cpu"),
                         Model(cfg, device="cpu").init(
                             torch.Generator().manual_seed(0)),
                         n_slots=2, max_len=MAX_LEN)
    assert eng._min_cache_len == 16
    pads = [eng._pad_ctx(np.zeros(n, np.int32)).shape[1]
            for n in range(4, MAX_LEN)]
    assert len(set(pads)) > tserve.PREFILL_GRAPHS
    made = []
    monkeypatch.setattr(tserve, "GraphProgram",
                        lambda fn, dev, **kw: made.append(kw) or fn)
    card = types.SimpleNamespace(dev=torch.device("cuda"), cfg=cfg,
                                 audio=False)
    tserve.PrefillProgram(card, MAX_LEN)
    assert made[0]["max_graphs"] == tserve.PREFILL_GRAPHS
    prog = _FakeCapture(lambda n: n, max_graphs=tserve.PREFILL_GRAPHS)
    for n in pads:
        prog(n)
    counts = prog.counts()
    assert counts["graphs"] == tserve.PREFILL_GRAPHS
    assert counts["evictions"] == len(set(pads)) - tserve.PREFILL_GRAPHS


# ---------------------------------------------------------------------------
# GreedyLoop: the SSM serve steps over fixed buffers
# ---------------------------------------------------------------------------

def _ssm_pair(arch):
    kw = dict(dtype="float32")
    jmodel = j_get_model(j_reduced(j_get_config(arch)).replace(**kw))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tree = with_norms_near_one(tree, np.random.default_rng(0))
    cfg = reduced(get_config(arch)).replace(**kw)
    return (jmodel, jax.tree.map(jnp.asarray, tree),
            Model(cfg, device="cpu"), params_from_numpy(tree, cfg))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_greedy_loop_keeps_its_buffers_and_the_reference_tokens(arch):
    """32 decode steps after a prefill: the caches, the token and position
    buffers never move (one decode graph serves every step on the card);
    every step's greedy token is the reference's where its top-2 margin is
    clear (the reference's token is fed to both)."""
    jmodel, jparams, model, params = _ssm_pair(arch)
    B, S, steps = 2, 16, 32
    toks = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, size=(B, S)).astype(np.int32)
    loop = GreedyLoop(model, B, S + steps + 1)
    bufs = graphs._leaves(loop.caches) + [loop.tokens, loop.pos]
    ptrs = [t.data_ptr() for t in bufs]
    lg, ids = loop.prefill(params, {"tokens": torch.from_numpy(toks)})
    jh, jc = jax.jit(j_make_prefill_step(jmodel, S + steps + 1))(
        jparams, {"tokens": jnp.asarray(toks)})
    jl = jmodel.logits(jparams, jh[:, -1:])[:, 0]
    nxt, _ = greedy(jl, lg)
    jstep = jax.jit(j_make_serve_step(jmodel))
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        lg, ids = loop.step(params, torch.from_numpy(nxt))
        assert [t.data_ptr() for t in bufs] == ptrs
        assert np.array_equal(loop.pos.numpy(), pos + 1)
        jl, jc = jstep(jparams, jc, jnp.asarray(nxt[:, None]),
                       jnp.asarray(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl[:, 0]),
                                   atol=5e-4, rtol=5e-3)
        nxt, _ = greedy(jl[:, 0], lg)
        pos = pos + 1
    assert loop.counts() == {}                  # no graph on the CPU
    loop.close()
    assert loop.caches is None
