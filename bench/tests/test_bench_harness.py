"""CPU tests of the benchmark harness: cells found by name, a cell added
from files alone, the generator's seeds, the metric arithmetic on worked
cases, the plain reference against the port at a tiny size, the control
and the planted faults coming out not correct, and the imports."""
from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import check, readers, roofline  # noqa: E402
from bench.cell import Cell, load_cell  # noqa: E402
from bench.harness import Run, Window, percentile  # noqa: E402
from bench.trace import DeviceTrace, idle_by_label, union  # noqa: E402
from bench.traffic import Traffic  # noqa: E402

BENCH = ROOT / "BENCHMARK.json"

TINY_MODEL = {"name": "tiny", "family": "dense", "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
              "d_ff": 128, "vocab_size": 256, "pattern": ["global"],
              "rope_theta": 10000.0, "tie_embeddings": False,
              "max_seq_len": 64, "norm_eps": 1e-6, "dtype": "bfloat16",
              "param_dtype": "float32"}
TINY_MOE = dict(TINY_MODEL, name="tiny-moe", family="moe", qk_norm=True,
                d_ff=32, moe={"n_experts": 8, "top_k": 2, "d_expert": 32,
                              "n_shared": 0, "norm_topk": True,
                              "capacity_factor": 4.0})
TINY_ENGINE = {"n_slots": 4, "max_len": 64, "page_size": 4,
               "cache_pages": 65}
CLOSED = {"name": "tiny_backlog", "loop": "closed",
          "tenants": [{"slots": 2, "share": 1, "clients": 3}] * 2,
          "prompt": {"median": 10, "sigma": 0.5, "lo": 4, "hi": 20},
          "output": {"median": 12, "sigma": 0.4, "lo": 6, "hi": 20},
          "max_context": 40, "mid_flight": True, "requests": 200}
OPEN = {"name": "tiny_chat", "loop": "open",
        "tenants": [{"slots": 2, "share": 2, "clients": 0},
                    {"slots": 2, "share": 1, "clients": 0}],
        "system_prompt": {"lo": 8, "hi": 16},
        "prompt": {"median": 6, "sigma": 0.5, "lo": 2, "hi": 12},
        "output": {"median": 8, "sigma": 0.5, "lo": 4, "hi": 12},
        "max_context": 40, "rate_per_s": 40.0, "warm_s": 0.1,
        "requests": 400}
# the tiny models' limit, on the CPU at seed 7: sound runs read a mean gap
# of 0 to 0.0054 (the MoE's widest gap, 0.53, is one routing flip), the
# fp8 control 0.017 to 0.089, the planted faults 0.9 and more
TINY_LIMITS = {"mean_gap": 0.01}


def tiny_cell(model=TINY_MODEL, traffic=CLOSED, limits=TINY_LIMITS) -> Cell:
    config = {"name": model["name"], "reference": "decoder", "model": model,
              "engine": TINY_ENGINE, "limits": limits}
    return Cell("tiny", 1, config, Traffic(traffic["name"], traffic), [],
                [])


def tiny_run(cell, seed=7, steps=30, **kw) -> Run:
    """A closed loop runs ``steps`` steps; an open loop half a second (its
    arrivals are on the clock)."""
    closed = cell.traffic.closed
    run = Run(cell, seed, 1e9 if closed else 0.5, False, device="cpu",
              max_steps=steps if closed else None, log=lambda *a: None, **kw)
    run.setup()
    run.window()
    return run


# ---------------------------------------------------------------------------
# cells, configurations, traffic and metrics found by name
# ---------------------------------------------------------------------------

def test_every_cell_loads_with_its_parts():
    spec = json.loads(BENCH.read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"], BENCH)
        assert cell.traffic.name == w["traffic"]
        assert cell.config["name"] == w["config"]
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(m.read)


def test_a_cell_is_added_from_files_alone(tmp_path):
    """A new configuration, traffic mix, metric and cell: files and a
    ``workloads`` entry, no code."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads(BENCH.read_text())
    (root / "bench" / "configs" / "tiny.json").write_text(json.dumps(
        tiny_cell().config))
    (root / "bench" / "traffic" / "tiny_chat.json").write_text(
        json.dumps(OPEN))
    (root / "bench" / "metrics" / "tokens_seen.chat.py").write_text(
        "def read(w):\n    return float(w.tokens)\n")
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "bench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.chat", "config": "tiny",
                              "traffic": "tiny_chat", "chips": 1,
                              "why": "test"})
    itl = next(m for m in spec["end_to_end"] if m["name"] == "itl_p95_ms")
    itl["workloads"].append("tiny.chat")
    spec["per_layer"].append({"name": "tokens_seen.chat", "unit": "tokens",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "itl_p95_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("tiny.chat", root / "BENCHMARK.json")
    assert cell.traffic.spec["rate_per_s"] == OPEN["rate_per_s"]
    assert [m.name for m in cell.end_to_end] == ["itl_p95_ms", "setup_s"]
    read = {m.name: m.read for m in cell.per_layer}
    assert list(read) == ["tokens_seen.chat"]
    assert read["tokens_seen.chat"](Window(
        {}, {}, 1.0, [], [], [], 0, 0, 5)) == 5.0
    run = tiny_run(cell, steps=5)
    assert run.results()["itl_p95_ms"] is not None


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traffic", [CLOSED, OPEN],
                         ids=["closed", "open"])
def test_same_seed_same_requests(traffic):
    t = Traffic(traffic["name"], traffic)
    big = 2 ** 31 + 12345
    a, b = t.requests(big, 256), t.requests(big, 256)
    c = t.requests(big + 1, 256)
    assert [(r.tenant, r.due_s, r.max_new_tokens) for r in a] == \
        [(r.tenant, r.due_s, r.max_new_tokens) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_every_seed_draws_the_same_sizes():
    """Lengths and gaps are one set of quantiles in a seeded order."""
    spec = dict(OPEN, system_prompt=None)
    t = Traffic("x", spec)
    a, b = t.requests(1, 256), t.requests(2, 256)
    for f in (lambda r: len(r.prompt), lambda r: r.max_new_tokens):
        assert sorted(map(f, a)) == sorted(map(f, b))
    gaps = lambda rs: sorted(np.round(np.diff(
        [-spec["warm_s"]] + [r.due_s for r in rs]), 9))
    assert gaps(a) == gaps(b)
    assert all(len(r.prompt) + r.max_new_tokens <= spec["max_context"]
               for r in a)


def test_open_loop_rate_and_shares():
    t = Traffic(OPEN["name"], OPEN)
    rs = t.requests(3, 256)
    due = [r.due_s for r in rs]
    assert due == sorted(due)
    rate = (len(due) - 1) / (due[-1] - due[0])
    assert abs(rate - OPEN["rate_per_s"]) / OPEN["rate_per_s"] < 0.01
    first = sum(r.tenant == "tenant-0" for r in rs) / len(rs)
    assert abs(first - 2 / 3) < 0.01
    sysp = t.system_prompts(3, 256)
    for r in rs[:50]:
        s = sysp[r.tenant]
        assert np.array_equal(r.prompt[:len(s)], s)


# ---------------------------------------------------------------------------
# the arithmetic, on hand-worked cases
# ---------------------------------------------------------------------------

def test_rate_and_percentile_over_the_whole_window():
    assert percentile(list(range(1, 101)), 95) == 95.0
    assert percentile([5.0], 95) == 5.0
    assert percentile([], 95) is None
    cell = tiny_cell(traffic=OPEN)
    run = Run(cell, 1, 1.0, False, device="cpu")
    run.t_open, run.t_close = 10.0, 12.0
    run.steps = [(10.0, 10.5), (10.5, 12.0)]
    from bench.harness import Record
    spec = Traffic(OPEN["name"], OPEN).requests(1, 256)[0]
    r1 = Record(spec, object(), 10.0, times=[10.2, 10.5, 12.0, 12.5])
    r2 = Record(spec, object(), 11.0, times=[11.5, 12.0])
    early = Record(spec, object(), 9.0, times=[9.5, 10.1])
    run.records = [r1, r2, early]
    run.setup_s = 3.0
    out = run.results()
    # tokens at 10.2, 10.5, 12.0 (r1), 11.5, 12.0 (r2), 10.1 over 2 s
    assert out["tokens_per_s"] == 3.0
    # gaps inside the window: 300, 1500 (r1), 500 (r2); 12.0 -> 12.5 and
    # 9.5 -> 10.1 cross its edges
    assert out["itl_p95_ms"] == 1500.0
    # open loop: TTFT from the due time of each request due in it (r1 200,
    # r2 500; the early one was due before the window)
    assert out["ttft_p95_ms"] == pytest.approx(500.0)
    assert run.attempted == 2


def test_flops_and_bytes_of_a_phi3_and_a_qwen3_moe_step():
    phi = json.loads((ROOT / "bench/configs/phi3-mini-3.8b.json")
                     .read_text())["model"]
    qwen = json.loads((ROOT / "bench/configs/qwen3-moe-30b-a3b.l12.json")
                      .read_text())["model"]
    # phi3: q,k,v,o 4 x 3072^2 and 3 x 3072 x 8192, two flops each
    assert roofline.layer_flops_per_token(phi) == \
        2 * 4 * 3072 * 3072 + 2 * 3 * 3072 * 8192
    # one decode token at context 100 and its logits row
    one = roofline.model_flops(phi, 1, 100, 1)
    assert one == 32 * (roofline.layer_flops_per_token(phi)
                        + 4 * 96 * 32 * 100) + 2 * 3072 * 32064
    # qwen3-moe: q,o 2048 x 4096, k,v 2048 x 512, router 2048 x 128, and
    # 8 of the 128 experts' three 2048 x 768 products
    assert roofline.layer_flops_per_token(qwen) == \
        2 * 2048 * 128 * (2 * 32 + 2 * 4) + 2 * 2048 * 128 \
        + 2 * 3 * 2048 * 768 * 8
    # decode bytes of one row at 33 valid keys, pages of 16 (3 blocks):
    # q and out, the position, 3 table entries, 33 K and V rows with pos
    b, f = roofline.decode_cost(33, 3, 32, 4, 128)
    assert b == 2 * 32 * 128 * 2 + 4 + 3 * 4 + 33 * (4 * 128 * 2 * 2 + 4)
    assert f == 4 * 128 * 32 * 33
    # causal prefill of 4 tokens: 10 pairs; with a window of 2: 1 + 2*3
    assert roofline.causal_keys(4) == 10
    assert roofline.causal_keys(4, 2) == 7
    b, f = roofline.flash_cost(4, 2, 1, 8)
    assert (b, f) == ((2 * 2 + 2) * 4 * 8 * 2, 4 * 8 * 2 * 10)


def test_shares_of_the_roofline_and_of_the_window():
    m = dict(TINY_MODEL, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=8)
    ev = [("decode_split_kernel<x>", 0.0, 0.3),
          ("void at::native::bfloat16_copy_kernel_cuda", 0.3, 0.4),
          ("flash_mma_kernel<y>", 0.5, 0.7), ("nvjet", 0.65, 0.8)]
    busy = union([(s, e) for _, s, e in ev])
    assert busy == [(0.0, 0.4), (0.5, 0.8)]
    dev = DeviceTrace(ev, 0.7, 1.0, {})
    w = Window(m, {"page_size": 4}, 1.0, [(0.0, 0.4), (0.4, 1.0)],
               [[5, 9]], [6], 20, 2, 2, dev)
    assert readers.idle_share(w) == pytest.approx(30.0)
    assert readers.cast_share(w) == pytest.approx(100 * 0.1 / 0.7)
    assert readers.iter_ms(w) == pytest.approx(500.0)
    assert readers.prefix_hit_share(w) == pytest.approx(100 * 2 * 4 / 20)
    rows = [roofline.decode_cost(r, -(-r // 4), 2, 1, 8) for r in (5, 9)]
    want = roofline.bound(sum(b for b, _ in rows),
                          sum(f for _, f in rows))[0] * 2
    assert readers.decode_attn_roofline(w) == pytest.approx(100 * want / 0.3)
    fb, ff = roofline.flash_cost(6, 2, 1, 8)
    assert readers.flash_roofline(w) == pytest.approx(
        100 * roofline.bound(fb, ff)[0] * 2 / 0.2)
    flops = roofline.model_flops(m, 2 + 6, 5 + 9 + 21, 2)
    assert readers.mfu(w) == pytest.approx(100 * flops / 989e12)
    # nothing to read: None, never 0
    empty = Window(m, {"page_size": 4}, 1.0, [], [], [], 0, 0, 0, None)
    for read in (readers.idle_share, readers.cast_share, readers.iter_ms,
                 readers.prefix_hit_share, readers.decode_attn_roofline,
                 readers.flash_roofline):
        assert read(empty) is None


@pytest.mark.parametrize("name,cast", [
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}",
     True),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}, "
     "at::native::memory::LoadWithCast<1>, at::native::memory::"
     "StoreWithCast<1> >", True),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl"
     "<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>", True),
    ("void at::native::elementwise_kernel<128, 4, at::native::"
     "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::"
     "TensorIteratorBase&)>", False),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}, "
     "at::native::memory::LoadWithoutCast, at::native::memory::"
     "StoreWithoutCast>", False),
    ("nvjet_tst_64x32_64x16_2x1_v_bz_NNT", False)],
    ids=["bf16", "cast-contiguous", "cast-strided", "strided-copy",
         "plain-copy", "gemm"])
def test_cast_share_counts_conversions_only(name, cast):
    assert readers.is_cast(name) is cast


def test_idle_gaps_by_host_span():
    busy = [(0.1, 0.2), (0.5, 0.6)]
    spans = [("step", 0.0, 0.3), ("step", 0.45, 0.9)]
    out = idle_by_label(busy, 0.0, 1.0, spans)
    # idle: [0, .1] [.2, .5] [.6, 1]; steps cover .1 + .1 + .05 + .3
    assert out["step"] == pytest.approx(0.55)
    assert out["between host spans"] == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# the system on the CPU at a tiny size, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,traffic", [(TINY_MODEL, CLOSED),
                                           (TINY_MOE, CLOSED),
                                           (TINY_MODEL, OPEN)],
                         ids=["dense-closed", "moe-closed", "dense-open"])
def test_sound_run_is_correct(model, traffic):
    run = tiny_run(tiny_cell(model, traffic))
    out = run.results()
    assert run.failed == 0 and run.attempted > 0
    assert out["setup_s"] > 0
    view = run.window_view()
    assert view.tokens > 0 and readers.iter_ms(view) > 0
    run.free()
    chk = run.check(control=True)
    assert chk["tokens"] > 0
    assert chk["correct"], chk
    # the control, the reference through fp8, fails the same limit
    assert any(chk["control"][k] > v for k, v in TINY_LIMITS.items()), chk


def _fault_token(monkeypatch):
    """A token altered where it is produced: the greedy id plus one."""
    from repro_torch.runtime import serve
    real = serve.greedy_tail

    def tail(out):
        logits, ids = real(out)
        return logits, (ids + 1) % TINY_MODEL["vocab_size"]
    monkeypatch.setattr(serve, "greedy_tail", tail)


def _fault_state(monkeypatch):
    """The decode step leaves the KV cache as it found it."""
    from repro_torch.models import stages
    real = stages.attn_decode_paged

    def frozen(p, x, positions, cache, block_tables, opts):
        scratch = {k: v.clone() for k, v in cache.items()}
        return real(p, x, positions, scratch, block_tables, opts)
    monkeypatch.setattr(stages, "attn_decode_paged", frozen)


def _fault_half(monkeypatch):
    """Half of the batch's rows left out of the step: their logits are
    never computed (zeros)."""
    from repro_torch.models import lm
    real = lm.lm_decode_paged

    def half(cfg, params, caches, tokens, pos, block_tables):
        logits, caches = real(cfg, params, caches, tokens, pos,
                              block_tables)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, caches
    monkeypatch.setattr(lm, "lm_decode_paged", half)


@pytest.mark.parametrize("plant", [_fault_token, _fault_state, _fault_half],
                         ids=["token-altered", "state-unchanged",
                              "half-batch"])
def test_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    run = tiny_run(tiny_cell(), steps=30)
    run.free()
    chk = run.check()
    assert not chk["correct"], chk


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("tree", ["bench", "src/repro_torch"])
def test_nothing_imports_jax_or_the_jax_package(tree):
    bad = {"jax", "jaxlib", "flax", "repro"}
    found = {(str(p.relative_to(ROOT)), name)
             for p in (ROOT / tree).rglob("*.py")
             for name in _imports(p) if name in bad}
    assert not found


def test_reference_imports_nothing_of_the_port():
    for p in (ROOT / "bench" / "reference").rglob("*.py"):
        names = set(_imports(p))
        assert not names & {"repro_torch", "bench", "repro"}, p


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from bench import run as cli
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(k, "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--workload", "phi3-mini.decode_backlog", "--seed",
                     "1", "--seconds", "1", "--trace", "0"]) == 1
    assert capsys.readouterr().out == ""


def test_run_refuses_outside_a_checkout(tmp_path):
    """Only BENCHMARK.json and bench/: no program to run."""
    import subprocess
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "phi3-mini.decode_backlog", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("plant", [False, True],
                         ids=["clean", "jax-loaded-by-the-check"])
def test_run_prints_no_result_once_jax_is_loaded(plant, monkeypatch,
                                                  capsys):
    """The whole command on the CPU, its look for a card skipped, with a
    tiny cell: a clean run prints its result last; a check that loads JAX
    (as a reference loaded from a file could) leaves no result."""
    import types
    from bench import cell as cells, harness
    from bench import run as cli
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(k, "")
    for k, v in (("is_available", lambda: True), ("device_count", lambda: 1),
                 ("max_memory_allocated", lambda: 0),
                 ("memory_allocated", lambda: 0),
                 ("get_device_name", lambda i=0: "cpu")):
        monkeypatch.setattr(torch.cuda, k, v)
    monkeypatch.setattr(cells, "load_cell", lambda *a: tiny_cell())
    # other tests of this process may have loaded JAX: out of sight here
    for name in [m for m in list(sys.modules) if cli.loaded_forbidden([m])]:
        monkeypatch.delitem(sys.modules, name)

    class CpuRun(Run):
        def __init__(self, cell, seed, seconds, trace, **kw):
            super().__init__(cell, seed, 1e9, trace, device="cpu",
                             max_steps=20, log=kw.get("log", print))

        def check(self, control=False):
            if plant:
                monkeypatch.setitem(sys.modules, "jax",
                                    types.ModuleType("jax"))
            return super().check(control)
    monkeypatch.setattr(harness, "Run", CpuRun)
    rc = cli.main(["--workload", "tiny", "--seed", str(2 ** 31 + 5),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    last = out.out.strip().splitlines()[-1]
    if plant:
        assert rc == 1 and "jax" in out.err
        assert not any('"attempted"' in l for l in out.out.splitlines())
    else:
        assert rc == 0
        line = json.loads(last)
        assert line["correct"] is True
        assert list(line["check"]) == list(TINY_LIMITS)


def test_forbidden_names_are_whole_top_level_names():
    from bench import run as cli
    assert cli.loaded_forbidden(["repro_torch", "repro_torch.core",
                                 "jaxtyping", "torch"]) == []
    assert cli.loaded_forbidden(["repro_torch", "repro.core", "jax.numpy",
                                 "flax"]) == ["flax", "jax", "repro"]
