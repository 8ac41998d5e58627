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


# ---------------------------------------------------------------------------
# The served tree: matmul weights cast once (Model.serving_params)
# ---------------------------------------------------------------------------

# the registry's tiny configs, bf16 compute over fp32 masters: dense
# untied, GQA with qk-norm and a tied table, a tied table with a final
# softcap, GQA with qk-norm and MoE without shared experts, MLA with
# shared experts, patches, the audio family
CAST_ARCHS = ["phi3-mini-3.8b", "gemma3-1b", "gemma2-9b",
              "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "llava-next-34b",
              "whisper-tiny"]
# (arch, paged): MLA latents are not paged (the engine refuses them)
ENGINE_CASES = [(a, paged) for a in CAST_ARCHS if a != "whisper-tiny"
                for paged in (False, True)
                if not (paged and a == "deepseek-v2-lite-16b")]
# the parent dict's key -> the leaves cast once ("" the root)
CAST = {"": {"head"},
        "attn": {"wq", "wk", "wv", "wo", "w_dkv", "w_uk", "w_uv"},
        "self_attn": {"wq", "wk", "wv", "wo"},
        "cross_attn": {"wq", "wk", "wv", "wo"},
        "mlp": {"wg", "wu", "wd"}, "moe": {"wg", "wu", "wd"},
        "shared": {"wg", "wu", "wd"}}


def _bf16_model(arch, **replace):
    cfg = reduced(get_config(arch)).replace(**replace)
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _pairs(master, served, name="", path=()):
    """(path, parent key, leaf name, master leaf, served leaf) of every
    tensor of two trees of one structure."""
    if isinstance(master, dict):
        assert set(master) == set(served)
        for k in master:
            if isinstance(master[k], torch.Tensor):
                yield path + (k,), name, k, master[k], served[k]
            else:
                yield from _pairs(master[k], served[k], k, path + (k,))
    elif isinstance(master, (tuple, list)):
        assert type(master) is type(served) and len(master) == len(served)
        for i, (m, s) in enumerate(zip(master, served)):
            yield from _pairs(m, s, name, path + (i,))


def _prompts(vocab, lengths=(3, 9, 17), seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("arch,paged", ENGINE_CASES,
                         ids=[f"{a}-{'paged' if p else 'dense'}"
                              for a, p in ENGINE_CASES])
def test_served_tree_token_logs_equal_the_masters(arch, paged):
    """An engine serving the cast-once tree gives, bit for bit, the token
    logs of the same engine bound to the fp32 masters, cast at each use;
    prompts straddle the decode-step prefill (3) and two pad buckets."""
    model, params = _bf16_model(arch)
    kw = dict(n_slots=2, max_len=64, **(PAGED if paged else {}))
    prompts = _prompts(model.cfg.vocab_size)
    served = BatchingEngine(model, params, **kw)
    assert served.cast_once_leaves > 0
    masters = BatchingEngine(model, params, **kw)
    masters.params = params
    assert _serve(served, prompts, 6) == _serve(masters, prompts, 6)


@pytest.mark.parametrize("arch", CAST_ARCHS)
def test_served_tree_decode_logits_equal_the_masters(arch):
    """The prefill's hidden states (with patches for the VLM) and three
    decode steps' logits from the served tree equal, bit for bit, those
    from the fp32 masters; the audio family decodes from its
    ``make_caches`` as its engine does."""
    model, params = _bf16_model(arch)
    cfg = model.cfg
    tree = model.serving_params(params).tree
    toks = torch.tensor([_prompts(cfg.vocab_size, (9,))[0]],
                        dtype=torch.int32)
    batch = {"tokens": toks[:, :-1]}
    if cfg.n_patches:
        batch["patches"] = torch.randn(
            (1, cfg.n_patches, cfg.d_model),
            generator=torch.Generator().manual_seed(1)) * 0.1
    runs = []
    for p in (params, tree):
        out = []
        if model.audio:
            caches, start = model.make_caches(1, 16), 0
        else:
            h, caches = model.prefill(p, batch, 64)
            out.append(h)
            start = toks.shape[1] - 1 + cfg.n_patches
        tok = toks[:, -1:]
        for i in range(3):
            logits, caches = model.decode(
                p, caches, tok, torch.tensor([start + i], dtype=torch.int32))
            out.append(logits)
            tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
        runs.append(out)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("arch", CAST_ARCHS)
def test_served_tree_casts_the_matmul_weights_only(arch):
    """Norms, the router and the embedding table are the master tensors,
    still fp32; every matmul weight is a bf16 copy, counted in
    ``cast_bytes`` and ``cast_leaves``."""
    model, params = _bf16_model(arch)
    served = model.serving_params(params)
    n = nbytes = 0
    for path, parent, name, m, s in _pairs(params, served.tree):
        assert m.dtype == torch.float32, path
        if name in CAST.get(parent, ()):
            assert s.dtype == torch.bfloat16 and s is not m, path
            assert torch.equal(s, m.to(torch.bfloat16)), path
            n += 1
            nbytes += s.numel() * 2
        else:
            assert s is m, path
    assert (served.cast_leaves, served.cast_bytes) == (n, nbytes)
    assert n > 0
    kinds = {p[-1] for p, *_ in _pairs(params, served.tree)}
    if model.cfg.moe is not None:
        assert "router" in kinds
    assert "tok" in kinds


@pytest.mark.parametrize("replace", [dict(dtype="float32"),
                                     dict(param_dtype="bfloat16")],
                         ids=["fp32_compute", "bf16_params"])
def test_no_copy_where_the_weights_are_in_the_compute_dtype(replace):
    """An fp32-compute engine, or a config whose params are in the compute
    dtype, serves the masters: no copy, every leaf the master itself."""
    model, params = _bf16_model("qwen3-moe-30b-a3b", **replace)
    eng = BatchingEngine(model, params, n_slots=2, max_len=64, **PAGED)
    assert eng.cast_once_bytes == eng.cast_once_leaves == 0
    assert all(s is m for *_, m, s in _pairs(params, eng.params))


def test_engines_over_one_master_tree_share_one_copy():
    """Two engines and a fleet's engines over one master tree bind the same
    copies; the copy lives as long as an engine holds it; the masters are
    fp32 and unchanged after serving."""
    import gc
    import weakref
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.runtime import GatewayFleet
    model, params = _bf16_model("qwen3-moe-30b-a3b")
    before = [(p, m.clone()) for p, _, _, m, _ in _pairs(params, params)]
    a = BatchingEngine(model, params, n_slots=2, max_len=64, **PAGED)
    b = BatchingEngine(model, dict(params), n_slots=4, max_len=64)
    copies = [(x, y) for (*_, m, x), (*_, y) in
              zip(_pairs(params, a.params), _pairs(params, b.params))
              if x is not m]
    assert len(copies) == a.cast_once_leaves > 0
    assert all(x is y for x, y in copies)
    assert (b.cast_once_bytes, b.cast_once_leaves) == \
        (a.cast_once_bytes, a.cast_once_leaves)
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=2),
                    device="cpu")
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64)
    engines = [fleet._ensure_engine(d) for d in hv.db.devices]
    assert len(engines) == 2
    assert all(x is y for eng in engines for (*_, x), (*_, y) in
               zip(_pairs(params, eng.params), _pairs(params, a.params)))
    for prompt in _prompts(model.cfg.vocab_size):
        a.submit(prompt, max_new_tokens=4)
    assert a.run_until_idle()
    for (path, m), (_, _, _, now, _) in zip(before, _pairs(params, params)):
        assert now.dtype == torch.float32 and torch.equal(m, now), path
    ref = weakref.ref(copies[0][0])
    del a, b, engines, fleet, hv, copies
    gc.collect()
    assert ref() is None


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_example_and_gateway_carry_the_served_tree(paged):
    """The decode program's example (configure's warm-up runs on zeros of
    it) holds the served tree's dtypes; the gateway's engine binds the
    copies, and ``gateway_up`` reports their bytes and number."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.runtime import ServingGateway
    from repro_torch.runtime.gateway import serve_example
    model, params = _bf16_model("phi3-mini-3.8b")
    example = serve_example(model, params, 2, 64, paged, 16, 16)
    served = model.serving_params(params).tree
    for path, _, _, s, e in _pairs(served, example[0]):
        assert e.device.type == "meta", path
        assert (e.dtype, e.shape) == (s.dtype, s.shape), path
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1),
                    device="cpu")
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64,
                        paged=paged, cache_pages=16)
    eng = gw.engine
    assert all(x is y for (*_, x), (*_, y) in
               zip(_pairs(params, eng.params), _pairs(params, served)))
    up = [e for e in hv.log if e["kind"] == "gateway_up"]
    assert len(up) == 1 and eng.cast_once_leaves > 0
    assert (up[0]["cast_once_bytes"], up[0]["cast_once_leaves"]) == \
        (eng.cast_once_bytes, eng.cast_once_leaves)
    gw.close()


def test_concurrent_serving_params_make_one_copy():
    """Threads that bind one master tree at once (a fleet's engines woken
    together) get one copy of each leaf, not one a thread."""
    import sys
    import threading
    model, params = _bf16_model("qwen3-moe-30b-a3b")
    trees, n = [], 16
    go = threading.Barrier(n)

    def bind():
        go.wait(timeout=30)
        trees.append(model.serving_params(params).tree)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bind) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(trees) == n
    for other in trees[1:]:
        assert all(x is y for (*_, x), (*_, y) in
                   zip(_pairs(params, trees[0]), _pairs(params, other)))
