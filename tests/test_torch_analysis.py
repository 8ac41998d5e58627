"""rc3e-check over the port (``repro_torch.analysis``), mirroring
tests/test_analysis.py: each static pass against fixture modules planting
exactly one violation per rule beside a clean twin (the kernel-wrapper
rules and torch's host-sync markers included), the executed registry and
tuner checks on the real registry (and a planted break of each), the
pragma + baseline machinery, and the CLI's exit-code contract on the
port's tree.

Fixture files are written under ``tmp_path/repro_torch/<subdir>/`` so the
workspace's canonical relative paths ("runtime/x.py") and the passes'
directory scoping behave exactly as they do on the real tree.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import determinism, hostsync, kernelpass, ownership
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.common import Workspace
from repro_torch.kernels import registry as kreg

REPO = Path(__file__).resolve().parents[1]


def _ws(tmp_path, files):
    root = tmp_path / "repro_torch"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return Workspace([root])


def _line(src, needle):
    """1-based line of the first fixture line containing ``needle``."""
    for i, ln in enumerate(textwrap.dedent(src).splitlines(), 1):
        if needle in ln:
            return i
    raise AssertionError(f"fixture needle not found: {needle}")


# ---------------------------------------------------------------------------
# ownership pass
# ---------------------------------------------------------------------------

OWNERSHIP_SRC = """
    class Pool:
        def _alloc_one(self, tenant):
            return 1

        def _decref(self, pid):
            pass

        def risky(self, tenant):
            pid = self._alloc_one(tenant)  # leak: validate below may raise
            self.validate(pid)
            return pid

        def careful(self, tenant):
            pid = self._alloc_one(tenant)  # guarded: handler rolls back
            try:
                self.validate(pid)
            except Exception:
                self._decref(pid)
                raise
            return pid

        def sloppy(self, tenant):
            self._alloc_one(tenant)  # dropped handle


    def _mark_cancelled(req):
        req.done = True


    class Fleet:
        def bad_evict(self, req):
            _mark_cancelled(req)  # journal entry never retired

        def good_evict(self, req):
            self.journal.pop(req.request_id, None)
            _mark_cancelled(req)
    """


def test_ownership_pass_exact_findings(tmp_path):
    ws = _ws(tmp_path, {"runtime/pool.py": OWNERSHIP_SRC})
    found = {(f.rule, f.symbol, f.line) for f in ownership.run(ws)}
    assert found == {
        ("unguarded-acquire", "Pool.risky",
         _line(OWNERSHIP_SRC, "# leak")),
        ("discarded-handle", "Pool.sloppy",
         _line(OWNERSHIP_SRC, "# dropped handle")),
        ("unretired-cancel", "Fleet.bad_evict",
         _line(OWNERSHIP_SRC, "# journal entry never retired")),
    }


UNSCRUBBED_SRC = """
    class Engine:
        def _flush_scrub(self):
            pass

        def good_admit(self, slot, tenant, toks):
            self._flush_scrub()
            return self.pool.admit(slot, tenant, toks)

        def good_drain(self, slot, tenant):
            for pid in self.pool.take_scrub():
                self.zero(pid)
            return self.pool.grow(slot, tenant)

        def bad_grow(self, slot, tenant):
            return self.pool.grow(slot, tenant)  # recycled page, no scrub

        def bad_cow(self, slot, b, tenant):
            src, dst = self.pool.cow(slot, b, tenant)  # no scrub either
            return dst

        def waived(self, slot, tenant, toks):
            return self.pool.admit(slot, tenant, toks)  # rc3e: allow-unscrubbed-free

        def not_a_pool(self, slot, tenant, toks):
            return self.queue.admit(slot, tenant, toks)
    """


def test_unscrubbed_free_exact_findings(tmp_path):
    ws = _ws(tmp_path, {"runtime/engine.py": UNSCRUBBED_SRC})
    found = {(f.rule, f.symbol, f.line) for f in ownership.run(ws)
             if f.rule == "unscrubbed-free"}
    assert found == {
        ("unscrubbed-free", "Engine.bad_grow",
         _line(UNSCRUBBED_SRC, "# recycled page, no scrub")),
        ("unscrubbed-free", "Engine.bad_cow",
         _line(UNSCRUBBED_SRC, "# no scrub either")),
    }


# ---------------------------------------------------------------------------
# hostsync pass: torch's markers
# ---------------------------------------------------------------------------

HOTPATH_SRC = """
    import numpy as np
    import torch


    class BatchingEngine:
        def step(self):
            logits = self._decode(self._upload(self.tokens))
            return self._sample(logits)

        def _sample(self, logits):
            return logits.argmax(-1).cpu()  # per-token download

        def _upload(self, tokens):  # rc3e: allow-host-sync (tiny input)
            return torch.from_numpy(tokens).to(self.device)

        def _decode(self, tok):
            return self.model(tok.to(self.device))   # already on the card

        def _cold_path(self, x):
            torch.cuda.synchronize()
            return x.cpu().numpy()
    """

# (the hot path's body, a twin that must stay clean or None)
MARKERS = {
    "item": ("return x.item()", "return x.sum()"),
    "cpu": ("return x.cpu()", "return x.cuda()"),
    "numpy": ("return x.numpy()", "return torch.from_numpy(x)"),
    "tolist": ("return x.tolist()", "return [1, 2].count(1)"),
    "synchronize": ("torch.cuda.synchronize()",
                    "torch.cuda.current_stream()"),
    "to-cpu": ('return x.to("cpu")', "return x.to(self.device)"),
    "to-device-cpu": ('return x.to(device="cpu")',
                      "return x.to(dtype=torch.float32)"),
    "to-torch-device-cpu": ('return x.to(torch.device("cpu"))',
                            'return x.to(torch.device("cuda"))'),
    "np-asarray": ("return np.asarray(x)", "return np.zeros(4)"),
    "float": ("return float(x)", "return float(1)"),
    "from-numpy-upload": ("return torch.from_numpy(x).to(self.device)",
                          "return torch.from_numpy(x)"),
    "as-tensor-upload": ("return torch.as_tensor(x, device=self.device)",
                         "return torch.as_tensor(x)"),
    "tensor-upload": ("return torch.tensor(x, device=self.device)",
                      'return torch.tensor(x, device="cpu")'),
}


def _hot(body):
    return f"""
    import numpy as np
    import torch


    class BatchingEngine:
        def step(self):
            return self._work(self.x)

        def _work(self, x):
            {body}
    """


def test_hostsync_flags_only_reachable_unpragmad_markers(tmp_path):
    ws = _ws(tmp_path, {"runtime/engine.py": HOTPATH_SRC})
    found = {(f.symbol, f.line) for f in hostsync.run(ws)}
    # _cold_path is not reachable from step; _upload carries the pragma;
    # .to(self.device) of a device tensor is no upload
    assert found == {("BatchingEngine._sample",
                      _line(HOTPATH_SRC, "# per-token download"))}


@pytest.mark.parametrize("marker", sorted(MARKERS))
def test_hostsync_torch_markers_and_clean_twins(tmp_path, marker):
    bad, good = MARKERS[marker]
    ws = _ws(tmp_path, {"runtime/bad.py": _hot(bad)})
    found = [(f.symbol, f.line) for f in hostsync.run(ws)]
    assert found == [("BatchingEngine._work", _line(_hot(bad), bad))], marker
    ws = _ws(tmp_path / "twin", {"runtime/good.py": _hot(good)})
    assert hostsync.run(ws) == [], marker
    waived = _hot(bad + "  # rc3e: allow-host-sync")
    ws = _ws(tmp_path / "waived", {"runtime/waived.py": waived})
    assert hostsync.run(ws) == [], marker


# ---------------------------------------------------------------------------
# determinism pass
# ---------------------------------------------------------------------------

DETERMINISM_SRC = """
    import random
    import time


    def bad_clock():
        return time.time()  # wall clock

    def ok_clock():
        return time.monotonic()

    def bad_rng():
        return random.random()  # process-global rng

    def bad_ctor(seed):
        return random.Random(seed)  # bypasses the choke point

    def seeded_rng(seed):
        return random.Random(seed)

    def bad_for(xs):
        for x in set(xs):  # salted order
            yield x

    def ok_for(xs):
        for x in sorted(set(xs)):
            yield x
    """


def test_determinism_pass_exact_findings(tmp_path):
    ws = _ws(tmp_path, {"runtime/chaosy.py": DETERMINISM_SRC})
    found = {(f.rule, f.symbol, f.line) for f in determinism.run(ws)}
    assert found == {
        ("time-time", "bad_clock", _line(DETERMINISM_SRC, "# wall clock")),
        ("unseeded-random", "bad_rng",
         _line(DETERMINISM_SRC, "# process-global rng")),
        ("unseeded-random", "bad_ctor",
         _line(DETERMINISM_SRC, "# bypasses the choke point")),
        ("set-iteration", "bad_for",
         _line(DETERMINISM_SRC, "# salted order")),
    }


def test_determinism_scoping_excludes_other_dirs(tmp_path):
    ws = _ws(tmp_path, {"kernels/free.py": DETERMINISM_SRC})
    assert {f.rule for f in determinism.run(ws)} == {"unseeded-random"}


ROUND_COUNTER_SRC = """
    class Loop:
        def bad_pace(self, fleet):
            return fleet.steps % 4  # round-counter read

        def ok_count(self, eng):
            eng.steps += 1          # an engine counting its own steps
            return self.ticks

        def waived(self, fleet):  # rc3e: allow-round-counter
            return fleet.steps
    """


def test_round_counter_flagged_in_event_loop_only(tmp_path):
    ws = _ws(tmp_path, {"runtime/events.py": ROUND_COUNTER_SRC})
    assert {(f.rule, f.symbol, f.line) for f in determinism.run(ws)} == {
        ("round-counter", "Loop.bad_pace",
         _line(ROUND_COUNTER_SRC, "# round-counter read"))}
    ws = _ws(tmp_path / "fleet", {"runtime/fleet.py": ROUND_COUNTER_SRC})
    assert not determinism.run(ws)


# ---------------------------------------------------------------------------
# kernel-wrapper pass
# ---------------------------------------------------------------------------

WRAPPER_SRC = """
    import torch

    from pkg import _lib


    def _check(a):
        if a.dim() != 2:
            raise ValueError("2-D")


    def good_cuda(a):
        _check(a)
        lib, fn = _entry()
        rc = fn(a.data_ptr())
        _lib.check(rc, lib, "good")
        _lib.launches["good"] += 1
        return a


    def twice_cuda(a):
        _check(a)
        lib, fn = _entry()
        rc = fn(a.data_ptr())  # counted twice
        _lib.check(rc, lib, "twice")
        _lib.launches["twice"] += 1
        _lib.launches["twice"] += 1


    def uncounted_cuda(a):
        _check(a)
        lib, fn = _entry()
        rc = fn(a.data_ptr())  # never counted
        _lib.check(rc, lib, "uncounted")


    def phantom(a):
        _lib.launches["phantom"] += 1  # counts with no launch


    def _launch(a):
        lib, fn = _entry()
        rc = fn(a.data_ptr())
        _lib.check(rc, lib, "helper")
        _lib.launches["helper"] += 1


    def checked_caller(a):
        if a.dtype != torch.float32:
            raise TypeError("fp32")
        return _launch(a)


    def _bare_launch(a):
        lib, fn = _entry()
        rc = fn(a.data_ptr())  # nothing checked the shapes
        _lib.check(rc, lib, "bare")
        _lib.launches["bare"] += 1


    def unchecked_caller(a):
        return _bare_launch(a)


    def fallback(a):
        try:
            return good_cuda(a)
        except RuntimeError:  # swallowed launch
            return a @ a


    def strict(a):
        try:
            _lib.build()
        except RuntimeError as e:
            raise RuntimeError("build failed") from e


    def tooling():
        try:
            return demangle()
        except OSError:
            return None
    """

BRANCH_SRC = """
    import torch


    def attend(q):
        if torch.cuda.is_available():  # another path without a card
            return q.cuda()
        return q


    def refuse(q):
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        return q
    """

OPS_SRC = """
    def _on_cuda(t, name):
        if t.device.type == "cuda":
            return True
        return False


    def good(q):
        fn = kernel if _on_cuda(q, "good") else plain
        return fn(q)


    def also_good(q):
        return kernel(q) if q.is_cuda else plain(q)


    def by_size(q):
        fn = kernel if q.numel() > 1024 else plain  # size decides
        return fn(q)
    """


def test_kernel_pass_exact_findings(tmp_path):
    ws = _ws(tmp_path, {"kernels/toy.py": WRAPPER_SRC,
                        "kernels/ops.py": OPS_SRC,
                        "layers/attn.py": BRANCH_SRC})
    found = {(f.rule, f.file, f.symbol, f.line) for f in kernelpass.run(ws)
             if f.rule not in ("registry-shapes", "tuner-shapes")}
    toy = "kernels/toy.py"
    assert found == {
        ("launch-count", toy, "twice_cuda",
         _line(WRAPPER_SRC, "# counted twice")),
        ("launch-count", toy, "uncounted_cuda",
         _line(WRAPPER_SRC, "# never counted")),
        ("launch-count", toy, "phantom",
         _line(WRAPPER_SRC, "# counts with no launch")),
        ("unchecked-launch", toy, "_bare_launch",
         _line(WRAPPER_SRC, "# nothing checked the shapes")),
        ("launch-fallback", toy, "fallback",
         _line(WRAPPER_SRC, "# swallowed launch")),
        ("cuda-branch", "layers/attn.py", "attend",
         _line(BRANCH_SRC, "# another path without a card")),
        ("ops-dispatch", "kernels/ops.py", "by_size",
         _line(OPS_SRC, "# size decides")),
    }


def test_kernel_pass_scoping(tmp_path):
    """The wrapper rules read ``kernels/`` only (ops-dispatch only
    ``kernels/ops.py``); the CUDA-branch rule the compute paths."""
    ws = _ws(tmp_path, {"runtime/toy.py": WRAPPER_SRC,
                        "runtime/ops.py": OPS_SRC,
                        "runtime/attn.py": BRANCH_SRC})
    assert {f.rule for f in kernelpass.run(ws)} <= {"registry-shapes",
                                                    "tuner-shapes"}


def test_kernel_pass_pragmas(tmp_path):
    src = WRAPPER_SRC.replace("# counts with no launch",
                              "# rc3e: allow-launch-count")
    ws = _ws(tmp_path, {"kernels/toy.py": src})
    assert "phantom" not in {f.symbol for f in kernelpass.run(ws)}


def test_executed_checks_clean_on_real_registry():
    assert kernelpass.check_registry_shapes() == []
    assert kernelpass.check_tuner_shapes() == []


def test_executed_checks_catch_planted_breaks(monkeypatch):
    """A page size that does not divide the configs' lengths, a head dim
    the kernels no longer take, a state dim dropped, a kernel grown past
    the card: each is a registry-shapes finding; a tuner that starts
    emitting an illegal page size is a tuner-shapes finding."""
    monkeypatch.setattr(kreg, "PAGE_SIZE_CHOICES", (8, 16, 48))
    monkeypatch.setattr(kreg, "HEAD_DIMS", (32, 64, 96, 112, 128))
    monkeypatch.setattr(kreg, "STATE_DIMS", (64, 128))
    monkeypatch.setattr(kreg, "SMEM_PER_BLOCK", 160 * 1024)
    found = {(f.symbol, f.message.split(" ", 1)[0])
             for f in kernelpass.check_registry_shapes()}
    assert ("smollm-135m:full", "max_len=2048") in found        # page 48
    assert ("gemma3-1b:full", "head_dim=256") in found          # no D 256
    assert ("mamba2-370m:reduced", "d_state=16") in found
    assert ("flash/D128/float32", "flash/D128/float32:") in found
    assert ("smollm-135m:full", "head_dim=64") not in found
    monkeypatch.undo()
    from repro_torch.tuning import cost_model, explorer, space
    monkeypatch.setattr(cost_model, "legal_reason", lambda *a, **k: None)
    monkeypatch.setattr(explorer, "enumerate_candidates", lambda **kw: iter(
        [space.TunedConfig(page_size=48, n_slots=8, prefill_chunk=2)]))
    found = kernelpass.check_tuner_shapes()
    assert len(found) == 4 and all(f.rule == "tuner-shapes" for f in found)
    assert {f.symbol for f in found} == {
        f"{a}:c{s:.2f}x:paged" for a in kernelpass.TUNER_ARCHS
        for s in kernelpass.TUNER_SPEEDS}
    assert all("page_size=48" in f.message for f in found)


# ---------------------------------------------------------------------------
# CLI + baseline machinery
# ---------------------------------------------------------------------------

def test_cli_baseline_roundtrip(tmp_path, capsys):
    root = tmp_path / "repro_torch" / "runtime"
    root.mkdir(parents=True)
    (root / "bad.py").write_text(textwrap.dedent(OWNERSHIP_SRC))
    baseline = tmp_path / "baseline.json"
    args = [str(tmp_path / "repro_torch"), "--baseline", str(baseline)]
    # fresh findings fail the build...
    assert main(args) == 1
    # ...grandfathering them (exit 0) makes the same tree pass...
    assert main(args + ["--write-baseline"]) == 0
    assert main(args) == 0
    # ...and a NEW violation still fails against the old baseline
    (root / "new.py").write_text(textwrap.dedent(HOTPATH_SRC))
    assert main(args) == 1
    assert main(args + ["--json"]) == 1
    capsys.readouterr()


def test_cli_usage_error_exits_2(tmp_path):
    with pytest.raises(SystemExit) as e:
        main([str(tmp_path / "missing")])
    assert e.value.code == 2


def test_port_tree_is_clean():
    """Acceptance: ``python -m repro_torch.analysis src/repro_torch`` exits
    0 on this tree, against the port's own (empty) baseline file."""
    assert (REPO / "analysis_baseline_torch.json").exists()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout
