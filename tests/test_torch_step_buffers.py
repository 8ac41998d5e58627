"""The serving engine's step buffers on the CPU. On the card a decode step
is a CUDA graph bound to the addresses of its inputs, so the engine keeps
one set of buffers for its whole life: the caches, and the tokens,
positions and block tables each step copies into. Here, for reduced
smollm-135m (fp32, the JAX init carried across), the ``data_ptr()`` of
every one of them stays fixed at every decode call, dense and paged,
through admissions in ``step`` and ``step_async``, contexts replayed token
by token (``_step_single``), preemption, copy-on-write, scrubbing and a
hand-off's page export and import, while the token logs stay the JAX
package's (``tests/torch_parity.py``'s margin premise asserted).

Also the parts of ``core/graphs.py`` and of the launch ledger that need no
card: which arguments a graph program binds by address and which it
stages, the capture tally's arithmetic, the source line a refusal names,
and whisper's position table, built without an upload, against the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as j_get_model
from repro.runtime import BatchingEngine as JEngine
from repro_torch.core import graphs
from repro_torch.kernels import _lib
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine
from test_torch_engine import SCENARIOS, _prompt, models  # noqa: F401
from torch_parity import assert_margins

torch.set_num_threads(1)


def _buffers(eng):
    """Every tensor a decode step is bound to, by name."""
    out = {"tokens": eng._tok, "positions": eng._posd}
    if eng.paged:
        out["block_tables"] = eng._bt
    for i, leaf in enumerate(graphs._leaves(eng.caches)):
        out[f"cache{i}"] = leaf
    return out


def _watch(eng):
    """Check the addresses of the step's buffers at every decode call
    against the engine's first; returns the list of calls."""
    first = {k: t.data_ptr() for k, t in _buffers(eng).items()}
    dec = eng._decode
    calls = []

    def decode(tokens, pos):
        assert {k: t.data_ptr() for k, t in _buffers(eng).items()} == first
        out = dec(tokens, pos)
        assert {k: t.data_ptr() for k, t in _buffers(eng).items()} == first
        calls.append(len(calls))
        return out

    eng._decode = decode
    return calls


def _serve(engine, spec, vocab, mode):
    reqs = [engine.submit(_prompt(vocab, n, seed), max_new_tokens=new,
                          tenant=tenant) for n, seed, tenant, new in spec]
    for _ in range(2000):
        if mode == "step":
            engine.step()
        else:
            engine.step_async(prefill_chunk=4)
        if engine.idle():
            break
    assert engine.idle()
    return [r.out_tokens for r in reqs]


def _pair(models, scenario, paged, **extra):
    jcfg, jparams, cfg, params = models
    kw, spec, quant = SCENARIOS[scenario]
    kw = dict(kw, paged=True, page_size=16) if paged else \
        {k: v for k, v in kw.items() if k != "cache_pages"}
    kw.update(extra)
    jmodel = j_get_model(jcfg.replace(kv_quant=quant))
    model = Model(cfg.replace(kv_quant=quant), device="cpu")
    return jmodel, jparams, model, params, kw, spec


@pytest.mark.parametrize("mode", ["step", "step_async"])
@pytest.mark.parametrize("scenario,paged", [
    ("mixed", False), ("mixed", True), ("cow", True), ("preempt", True),
    ("kv_quant", True)])
def test_step_buffers_stay_put(models, scenario, paged, mode):
    """Admissions (batched prefills and short contexts replayed token by
    token through ``_step_single``), copy-on-write, preemption and
    scrubbing between decode steps leave every step buffer where it was;
    the token logs equal the JAX engine's."""
    jmodel, jparams, model, params, kw, spec = _pair(models, scenario, paged)
    vocab = models[2].vocab_size
    eng = BatchingEngine(model, params, **kw)
    calls = _watch(eng)
    logs = _serve(eng, spec, vocab, mode)
    assert calls and len(calls) >= eng.steps
    want = _serve(JEngine(jmodel, jparams, **kw), spec, vocab, mode)
    assert logs == want
    assert_margins(jmodel, jparams,
                   [_prompt(vocab, n, seed) for n, seed, _, _ in spec],
                   want, kw["max_len"])
    if scenario == "cow":
        assert eng.pool.stats()["cow_copies"] >= 1
    if scenario == "preempt":
        assert eng.preemptions > 0
    if paged:
        assert eng.pool.pages_scrubbed > 0


def test_legacy_prefill_replays_every_context_token_in_place(models):
    """``prefill_mode="legacy"`` sends every context token through the
    decode step (``_step_single``) on the same buffers; logs as the JAX
    engine's in the same mode."""
    jmodel, jparams, model, params, kw, spec = _pair(
        models, "mixed", False, prefill_mode="legacy")
    eng = BatchingEngine(model, params, **kw)
    calls = _watch(eng)
    logs = _serve(eng, spec, models[2].vocab_size, "step")
    assert len(calls) > eng.steps          # context tokens replayed too
    assert logs == _serve(JEngine(jmodel, jparams, **kw), spec,
                          models[2].vocab_size, "step")


def _handoff(Engine, model, params, vocab):
    """Export a request's pages mid-decode, let the source decode one more
    token, move the request and import its pages (the target catches the
    token up through its decode step)."""
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=16)
    src, dst = Engine(model, params, **kw), Engine(model, params, **kw)
    watched = [] if Engine is JEngine else [_watch(src), _watch(dst)]
    req = src.submit(_prompt(vocab, 20, 3), max_new_tokens=10, tenant="m")
    stay = src.submit(_prompt(vocab, 9, 4), max_new_tokens=10, tenant="s")
    for _ in range(3):
        src.step()
    payload = src.export_request_pages(req)
    ctx = len(src._ctx_tokens(req))
    src.step()
    src.drain_tenant("m")
    assert dst.import_request_pages(req, payload, ctx_len=ctx)
    assert src.run_until_idle() and dst.run_until_idle()
    return [req.out_tokens, stay.out_tokens], watched


def test_handoff_pages_move_between_fixed_buffers(models):
    """A hand-off's export and import copy pages into and out of pools
    whose addresses do not move; the logs equal the JAX engines'."""
    jcfg, jparams, cfg, params = models
    model = Model(cfg, device="cpu")
    logs, watched = _handoff(BatchingEngine, model, params, cfg.vocab_size)
    want, _ = _handoff(JEngine, j_get_model(jcfg), jparams, cfg.vocab_size)
    assert logs == want
    assert all(watched)


# ---------------------------------------------------------------------------
# The graph program's bookkeeping and the launch ledger
# ---------------------------------------------------------------------------

def test_binding_binds_device_tensors_and_stages_host_arrays():
    """On the program's device a tensor binds by address (and strides); a
    numpy array, or a tensor elsewhere, is staged by shape and dtype; any
    other leaf is keyed by value; the tree's structure is in the key."""
    cpu = torch.device("cpu")
    w = torch.zeros((4, 6))
    host = np.zeros((2, 3), np.int32)
    meta = torch.empty((5,), device="meta")
    leaves, key = graphs.binding(({"w": w}, [host, meta], 3, None), cpu)
    kinds = [k[0] for k in key[1]]
    assert kinds == ["bound", "staged", "staged", "value", "value"]
    assert key[1][0] == ("bound", w.data_ptr(), w.shape, w.stride(),
                         w.dtype)
    assert leaves[1] is host
    same = graphs.binding(({"w": w}, [host * 2, meta], 3, None), cpu)[1]
    assert same == key                      # host contents are not keyed
    assert graphs.binding(({"w": w.clone()}, [host, meta], 3, None),
                          cpu)[1] != key    # another address
    sq = torch.zeros((4, 4))
    assert graphs.binding((sq,), cpu)[1] != graphs.binding(
        (sq.t(),), cpu)[1]                  # same address, other strides
    assert graphs.binding(({"v": w}, [host, meta], 3, None), cpu)[1] != key
    assert graphs.binding(({"w": w}, [host, meta], 4, None), cpu)[1] != key
    assert graphs.binding(({"w": w}, (host, meta), 3, None), cpu)[1] != key


def test_rebuild_and_then_keep_the_tree():
    """``rebuild`` refills a tree and keeps no leaf alive past its use (a
    graph is dropped when a tensor it is bound to dies: a reference cycle
    would hold the tensors until the garbage collector ran)."""
    import gc
    import weakref
    tree = ({"a": 1, "b": [2, 3]}, (4,))
    assert graphs.rebuild(tree, [10, 20, 30, 40]) == \
        ({"a": 10, "b": [20, 30]}, (40,))
    xs = [torch.zeros(2), torch.zeros(3), torch.zeros(1), torch.zeros(4)]
    refs = [weakref.ref(x) for x in xs]
    gc.disable()
    try:
        out = graphs.rebuild(tree, xs)
        del xs, out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
    step = graphs.then(lambda x: (x, x + 1), lambda out: out[1] * 2)
    assert step(3) == 8
    plain = lambda x: x                     # noqa: E731
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.GraphProgram(plain, "cpu")


def test_pool_takes_a_new_handle_once_its_graphs_are_gone():
    """The graphs of a program and of its chained programs share one pool;
    once none of them lives the handle is dropped (the allocator freed the
    pool with its last graph) and the next capture takes a new one."""
    pool = graphs._Pool()
    pool.handle, pool.live = (0, 7), 2
    pool.dropped()
    assert pool.handle == (0, 7) and pool.live == 1
    pool.dropped()
    assert pool.handle is None and pool.live == 0


def test_capture_tally_arithmetic(monkeypatch):
    """Under a capture a wrapper's ``launches[name] += 1`` goes to the
    open tally, not the counts; each replay adds the tally; a capture with
    no tally open refuses the launch."""
    _lib.launches.reset()
    _lib.launches["flash_attention"] += 1          # an eager launch
    monkeypatch.setattr(_lib, "_capturing", lambda: True)
    with _lib.capture_tally() as tally:
        for _ in range(3):
            _lib.launches["decode_attention"] += 1
        _lib.launches["decode_group"] += 1
        with pytest.raises(RuntimeError, match="already open"):
            with _lib.capture_tally():
                pass
    assert tally == {"decode_attention": 3, "decode_group": 1}
    assert _lib.launches["decode_attention"] == 0
    with pytest.raises(RuntimeError, match="keeps no launch tally"):
        _lib.launches["decode_attention"] += 1
    monkeypatch.setattr(_lib, "_capturing", lambda: False)
    for _ in range(4):
        _lib.launches.replayed(tally)
    assert _lib.launches["decode_attention"] == 12
    assert _lib.launches["decode_group"] == 4
    assert _lib.launches["flash_attention"] == 1
    _lib.launches.reset()
    assert not any(_lib.launches.values())


def test_refusal_names_the_op():
    """The message of a refused capture names the op's source line."""
    def step(x):
        y = x + 1
        return y.tolist()[5]

    try:
        step(torch.zeros(2))
    except IndexError as e:
        where = graphs._op_source(e)
    assert "`return y.tolist()[5]`" in where
    assert "test_torch_step_buffers.py" in where and "in step" in where


def test_whisper_position_table_equals_the_reference():
    """whisper's decode step rebuilds its sinusoidal table every step; the
    port fills the base on the device instead of uploading it (capturable).
    The table is bit for bit the one built from an uploaded base, and the
    reference's within fp32's rounding of sin at angles up to ``seq``
    radians (the two packages' pow differ in the last bit)."""
    from repro.layers.embeddings import sinusoidal_positions as j_table
    from repro_torch.layers.embeddings import sinusoidal_positions
    for seq, d in ((448, 384), (7, 64), (1500, 96)):
        got = sinusoidal_positions(seq, d)
        pos = torch.arange(seq, dtype=torch.float32)[:, None]
        dim = torch.arange(0, d, 2, dtype=torch.float32)[None, :]
        ang = pos / torch.pow(torch.tensor(10000.0), dim / d)
        uploaded = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]
        assert torch.equal(got, uploaded)
        want = np.asarray(j_table(seq, d, jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    jax.clear_caches()


def test_launcher_reports_its_programs(capsys):
    """The serving launcher reports the decode program's configures, CUDA
    graph captures and replays (on the CPU the program runs eagerly: one
    configure, no graph)."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", "smollm-135m", "--reduce", "--device", "cpu",
                      "--requests", "3", "--devices", "2", "--max-new", "2"])
    assert (out["configures"], out["captures"], out["replays"]) == (1, 0, 0)
    assert "programs: 1 configure(s), 0 CUDA graph capture(s), 0 replay(s)" \
        in capsys.readouterr().out
