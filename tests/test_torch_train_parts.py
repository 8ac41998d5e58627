"""The port's training parts against the JAX package, on the same numpy
inputs: the chunked and full cross-entropy (every case of
tests/test_runtime.py, and the VLM label-slice clamp mirrored), AdamW (20
steps of seeded gradients, the schedule, and the reference's own cases),
int8 quantization and error feedback, the synthetic data pipeline, the
meta-device input specs and the leaf order of the port's trees. Also the
repair of the SSM layer: under a recorded graph it takes the chunked
einsum form and every SSM parameter gets a gradient.

Tolerances: xent values 1e-4 and input gradients atol 1e-5 / rtol 1e-4
(as the reference's own tests); the VLM clamp 1e-5; AdamW params and
moments rtol 1e-6; int8 q exactly, scale within 1 ulp; error feedback
1e-6.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.models import get_model as j_get_model
from repro.models import input_specs as j_input_specs
from repro.optim import adamw_update as j_adamw_update
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim import quantize_int8 as j_quantize_int8
from repro.optim import schedule as j_schedule
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime import chunked_xent as j_chunked_xent
from repro.runtime import full_xent as j_full_xent
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model, input_specs
from repro_torch.optim import (AdamWConfig, adamw_update, dequantize_int8,
                               init_opt_state, quantize_int8, schedule)
from repro_torch.optim.compress import (compressed_psum, init_residuals,
                                        wire_bytes_fp32, wire_bytes_int8)
from repro_torch.runtime import chunked_xent, full_xent
from repro_torch.tree import flatten, tree_map, unflatten

torch.set_num_threads(1)


def _pair(arch, **replace):
    """(JAX cfg, JAX params, port cfg, port params) of reduced ``arch``,
    fp32, the JAX init carried across."""
    jcfg = j_reduced(j_get_config(arch)).replace(dtype="float32", **replace)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch)).replace(dtype="float32", **replace)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


def _xent_inputs(cfg, seq, rows=2, positions=None):
    h = np.array(jax.random.normal(
        jax.random.PRNGKey(1), (rows, positions or seq, cfg.d_model)))
    labels = np.array(jax.random.randint(
        jax.random.PRNGKey(2), (rows, seq), 0, cfg.vocab_size))
    return h, labels


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,chunk", [(32, 8), (32, 32), (48, 16), (30, 7)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_xent_matches_reference(seq, chunk, softcap):
    """tests/test_runtime.py::test_chunked_xent_matches_full on both
    packages: the port's chunked and full losses against each other and
    against the reference's."""
    jcfg, jparams, cfg, params = _pair("smollm-135m", final_softcap=softcap)
    h, labels = _xent_inputs(cfg, seq)
    th, tl = torch.tensor(h), torch.tensor(labels)
    a = float(chunked_xent(cfg, params, th, tl, chunk=chunk))
    b = float(full_xent(cfg, params, th, tl))
    ja = float(j_chunked_xent(jcfg, jparams, jnp.asarray(h),
                              jnp.asarray(labels), chunk=chunk))
    jb = float(j_full_xent(jcfg, jparams, jnp.asarray(h),
                           jnp.asarray(labels)))
    assert abs(a - b) < 1e-4
    assert abs(a - ja) < 1e-4 and abs(b - jb) < 1e-4


def test_chunked_xent_grads_match_reference():
    """The gradient with respect to h, chunked (each chunk recomputed in
    the backward pass) against full, and against the reference's."""
    jcfg, jparams, cfg, params = _pair("smollm-135m")
    h, labels = _xent_inputs(cfg, 32)
    tl = torch.from_numpy(labels)

    def grad(fn):
        th = torch.from_numpy(h).requires_grad_(True)
        return torch.autograd.grad(fn(th), th)[0].numpy()

    ga = grad(lambda hh: chunked_xent(cfg, params, hh, tl, chunk=8))
    gb = grad(lambda hh: full_xent(cfg, params, hh, tl))
    jg = np.asarray(jax.grad(lambda hh: j_chunked_xent(
        jcfg, jparams, hh, jnp.asarray(labels), chunk=8))(jnp.asarray(h)))
    np.testing.assert_allclose(ga, gb, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ga, jg, atol=1e-5, rtol=1e-4)


def test_vlm_label_slices_mirror_the_reference_clamp():
    """A VLM's h covers 16 patches + 16 tokens, its labels the 16 tokens.
    At chunk 8 the reference's ``dynamic_slice_in_dim`` clamps the label
    starts to 0, 8, 8, 8 (misaligned: ROADMAP Queue 3); the port reads the
    same slices and gives the same value, not the aligned one."""
    jcfg, jparams, cfg, params = _pair("llava-next-34b")
    assert cfg.n_patches == 16
    h, labels = _xent_inputs(cfg, 16, positions=32)
    th, tl = torch.from_numpy(h), torch.from_numpy(labels)
    got = float(chunked_xent(cfg, params, th, tl, chunk=8))
    want = float(j_chunked_xent(jcfg, jparams, jnp.asarray(h),
                                jnp.asarray(labels), chunk=8))
    assert abs(got - want) < 1e-5
    clamped = sum(float(full_xent(cfg, params, th[:, i:i + 8],
                                  tl[:, s:s + 8])) * 16
                  for i, s in zip((0, 8, 16, 24), (0, 8, 8, 8))) / 64
    aligned = float(full_xent(cfg, params, th[:, 16:], tl))
    assert abs(got - clamped) < 1e-5 and abs(got - aligned) > 1e-3


def test_xent_raises_where_the_reference_raises():
    """A chunk longer than the labels (the default 512 at 16 tokens): the
    reference's slice refuses it, and so does the port. ``full_xent`` on
    the VLM's unequal shapes: both refuse."""
    jcfg, jparams, cfg, params = _pair("llava-next-34b")
    h, labels = _xent_inputs(cfg, 16, positions=32)
    with pytest.raises(TypeError):
        j_chunked_xent(jcfg, jparams, jnp.asarray(h), jnp.asarray(labels))
    with pytest.raises(ValueError, match="longer than the 16 labels"):
        chunked_xent(cfg, params, torch.from_numpy(h),
                     torch.from_numpy(labels))
    with pytest.raises(ValueError):
        j_full_xent(jcfg, jparams, jnp.asarray(h), jnp.asarray(labels))
    with pytest.raises(ValueError, match="do not match"):
        full_xent(cfg, params, torch.from_numpy(h), torch.from_numpy(labels))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _grad_tree(rng):
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "blk": ({"a": rng.standard_normal(32).astype(np.float32)},
                    {"a": rng.standard_normal(32).astype(np.float32)}),
            "b": rng.standard_normal(5).astype(np.float32)}


def test_adamw_matches_reference_over_20_steps():
    """The same seeded gradients through warmup and into the cosine decay,
    weight decay on. Unclipped: the global norm is a reduction whose
    summation order differs between XLA and torch by an ulp, and a
    clipped update carries that ulp into every element (a parameter near
    0 then shows it as a large relative error); the clip is held below."""
    kw = dict(lr=1e-2, warmup_steps=5, total_steps=30, clip_norm=1e9)
    jcfg, cfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = _grad_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    jopt, topt = j_init_opt_state(jp), init_opt_state(tp)
    for _ in range(20):
        g = _grad_tree(rng)
        jp, jopt, jm = j_adamw_update(jcfg, jax.tree.map(jnp.asarray, g),
                                      jopt, jp)
        tp, topt, tm = adamw_update(cfg, tree_map(torch.from_numpy, g),
                                    topt, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    for jtree, ttree in ((jp, tp), (jopt["mu"], topt["mu"]),
                         (jopt["nu"], topt["nu"])):
        for a, b in zip(jax.tree.leaves(jtree), flatten(ttree)[0]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    assert int(topt["count"]) == int(jopt["count"]) == 20


def test_clip_by_global_norm_matches_reference():
    """Clipped gradients (norm ~ 12 against clip 1) and the pre-clip norm
    of 20 seeded trees, within rtol 1e-6 of the reference's."""
    from repro.optim import clip_by_global_norm as j_clip
    from repro_torch.optim import clip_by_global_norm
    rng = np.random.default_rng(1)
    for _ in range(20):
        g = _grad_tree(rng)
        jc, jn = j_clip(jax.tree.map(jnp.asarray, g), 1.0)
        tc, tn = clip_by_global_norm(tree_map(torch.from_numpy, g), 1.0)
        assert float(jn) > 1.0
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(jc), flatten(tc)[0]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_schedule_matches_reference():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in range(121):
        np.testing.assert_allclose(
            float(schedule(AdamWConfig(**kw), torch.tensor(s))),
            float(j_schedule(JAdamWConfig(**kw), jnp.asarray(s))),
            rtol=1e-6)


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    for _ in range(200):
        params, opt, _ = adamw_update(cfg, {"w": 2 * params["w"]}, opt,
                                      params)
    assert float(params["w"].abs().max()) < 0.05


def test_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(schedule(cfg, torch.tensor(s))) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6


def test_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    _, _, metrics = adamw_update(AdamWConfig(clip_norm=1.0),
                                 {"w": torch.full((3,), 1e6)},
                                 init_opt_state(params), params)
    assert float(metrics["grad_norm"]) > 1e6  # reported pre-clip


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_int8_quant_matches_reference(seed):
    """q equal exactly (both round half to even), scale within 1 ulp, and
    the reference's bound on the error."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), (64,)) * 10)
    jq, js = j_quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= np.spacing(np.float32(js))
    err = (dequantize_int8(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_matches_reference(tmp_path):
    """The port's ``compressed_psum`` on a gloo world of 1 against the
    reference's on a one-device mesh, over the same 30 gradients: each
    step's mean and the residual within 1e-6; error feedback keeps the
    cumulative error at a single step's scale (the reference's test)."""
    import torch.distributed as dist
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim.compress import compressed_psum as j_psum
    from repro.optim.compress import init_residuals as j_init_res
    from repro.runtime.sharding import shard_map
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    spec = {"w": P()}
    # not jitted, as the reference's own test runs it: under jit XLA fuses
    # the residual's multiply-subtract into an FMA (1 ulp a step, carried)
    j_step = shard_map(lambda g, r: j_psum(g, r, "data"), mesh,
                       in_specs=(spec, spec), out_specs=(spec, spec))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        jres = j_init_res({"w": jnp.zeros(128)})
        tres = init_residuals({"w": torch.zeros(128)})
        total_c, total_t = torch.zeros(128), torch.zeros(128)
        for i in range(30):
            g = np.array(jax.random.normal(jax.random.PRNGKey(i), (128,)))
            jc, jres = j_step({"w": jnp.asarray(g)}, jres)
            tc, tres = compressed_psum({"w": torch.from_numpy(g)}, tres)
            np.testing.assert_allclose(tc["w"].numpy(), np.asarray(jc["w"]),
                                       atol=1e-6)
            np.testing.assert_allclose(tres["w"].numpy(),
                                       np.asarray(jres["w"]), atol=1e-6)
            total_c += tc["w"]
            total_t += torch.from_numpy(g)
    finally:
        dist.destroy_process_group()
    assert float((total_c - total_t).abs().max()) < 0.2


def test_wire_bytes():
    g = {"a": torch.zeros(10, 4), "b": (torch.zeros(3),)}
    assert wire_bytes_fp32(g) == 43 * 4
    assert wire_bytes_int8(g) == 43 + 2 * 4


# ---------------------------------------------------------------------------
# Data, specs, trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_data_pipeline_matches_reference(n_hosts):
    for host in range(n_hosts):
        kw = dict(vocab_size=512, seq_len=64, batch_size=8, seed=3,
                  n_hosts=n_hosts, host_index=host)
        mine, ref = DataPipeline(DataConfig(**kw)), \
            JDataPipeline(JDataConfig(**kw))
        for step in range(10):
            a, b = mine.batch_at(step), ref.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert mine.unigram_entropy_nats(20_000) == \
        ref.unigram_entropy_nats(20_000)


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_input_specs_match_reference(cell):
    """Meta-device stand-ins of the reference's shapes and dtypes, caches
    of ``decode`` cells included, leaf for leaf, for every arch."""
    for arch in J_ARCH_IDS:
        ref = jax.tree.leaves(j_input_specs(j_get_config(arch),
                                            J_SHAPES[cell]))
        got = flatten(input_specs(get_config(arch), SHAPES[cell]))[0]
        assert [(tuple(x.shape), str(x.dtype)) for x in ref] == \
            [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
             for t in got], (arch, cell)
        assert all(t.device.type == "meta" for t in got)


def test_tree_order_is_the_references():
    """``repro_torch.tree.flatten`` visits leaves in ``jax.tree.leaves``
    order (dict keys sorted whatever their insertion order, tuples and
    lists in order, None an empty subtree), and unflatten inverts it. The
    step-0 gradient parity of every family (test_torch_train_step_*)
    holds it on the real parameter trees."""
    def tree(leaf):
        return {"z": (leaf(2), {"b": leaf(3), "a": leaf(4)}), "m": None,
                "a": [leaf(5), (leaf(6),)], "k": {"y": leaf(7), "x": {}}}
    ref = [int(x) for x in jax.tree.leaves(tree(jnp.int32))]
    leaves, spec = flatten(tree(torch.tensor))
    assert [int(t) for t in leaves] == ref == [5, 6, 7, 2, 4, 3]
    back = unflatten(spec, leaves)
    assert list(back) == sorted(tree(int)) and back["m"] is None
    assert flatten(back)[0] == leaves
    _, jparams, _, params = _pair("smollm-135m")
    for a, b in zip(jax.tree.leaves(jparams), flatten(params)[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_trees_leave_no_cycles_holding_tensors():
    """flatten / unflatten / tree_map and an AdamW update keep no tensor
    alive once their results are dropped, without a garbage collection
    (a reference cycle over the leaves held a whole optimiser state on the
    card until the collector ran)."""
    import gc
    import weakref
    gc.disable()
    try:
        params = {"b": (torch.ones(3),), "a": {"x": torch.ones(2, 2)}}
        opt = init_opt_state(params)
        refs = [weakref.ref(t) for t in flatten((params, opt))[0]]
        new, opt2, _ = adamw_update(AdamWConfig(), tree_map(
            torch.ones_like, params), opt, params)
        refs += [weakref.ref(t) for t in flatten((new, opt2))[0]]
        leaves, spec = flatten(unflatten(*reversed(flatten(new))))
        del params, opt, new, opt2, leaves, spec
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# The SSM layer under autograd (the repair)
# ---------------------------------------------------------------------------

def test_ssm_trains_on_its_plain_path(monkeypatch):
    """Reduced mamba2 (gate norms near 1): a forward that records a graph
    never reaches ``ops.ssd`` (the kernel's dispatch; on the card the
    kernel defines no backward) and every SSM parameter gets a nonzero
    gradient; under ``torch.no_grad`` the serving forward still does."""
    from repro_torch.kernels import ops
    from repro_torch.layers import ssm
    from torch_parity import with_norms_near_one
    jcfg = j_reduced(j_get_config("mamba2-370m")).replace(dtype="float32")
    tree = with_norms_near_one(jax.tree.map(np.asarray, j_get_model(
        jcfg).init(jax.random.PRNGKey(0))), np.random.default_rng(0))
    cfg = reduced(get_config("mamba2-370m")).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    flat, spec = flatten(params_from_numpy(tree, cfg))
    leaves = [p.requires_grad_(True) for p in flat]
    params = unflatten(spec, leaves)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    calls = []
    real = ops.ssd
    monkeypatch.setattr(ssm.ops, "ssd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    h, _ = model.forward(params, {"tokens": tokens})
    assert not calls
    grads = torch.autograd.grad(h.square().sum(), leaves)
    ssm_leaves = [(i, g) for i, (g, p) in enumerate(zip(grads, leaves))
                  if p.dim() > 0 and p.shape[0] == cfg.n_layers]
    assert len(ssm_leaves) == 9           # the 8 SSM leaves and norm1
    for i, g in ssm_leaves:
        assert float(g.abs().max()) > 0, f"leaf {i}: zero gradient"
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens}, 64)
    assert len(calls) == cfg.n_layers
