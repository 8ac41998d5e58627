"""The span recorder (``repro_torch.core.spans``) on the serving path.

On the CPU: a paged engine through ``ServingGateway`` with the recorder off
(nothing kept, no event recorded) and on (every span inside its step's
root, the request's spans carrying its id, self times not negative), the
prefill counts on prompts with a shared system prefix and a bucket pad,
and a stand-in event class showing that no event pair is read while the
steps run. On the card (marked ``cuda``): the decode graph's replays and
the scrub timed by events, and no step waiting on them.

Weights: reduced smollm-135m in fp32, seeded.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import ClusterSpec, Hypervisor
from repro_torch.core.spans import Records, recorder
from repro_torch.models import Model
from repro_torch.runtime import ServingGateway

torch.set_num_threads(1)

PAGE = 4
SYSTEM = 10             # a system prompt of 2.5 pages
USER = 5                # prompts of 15 tokens: contexts of 14, bucket 16


@pytest.fixture(scope="module")
def served():
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


@pytest.fixture
def rec():
    """The process-wide recorder, emptied and switched off afterwards."""
    recorder.records()
    yield recorder
    recorder.disable()
    recorder.records()


def _gateway(served, device="cpu", paged=True):
    cfg, model, params = served
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1),
                    device=device)
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=64,
                        paged=paged, page_size=PAGE, cache_pages=65)
    gw.open_session("a", slots=2)
    gw.open_session("b", slots=2)
    return gw


def _serve(gw, cfg, n=6, new=4):
    """``n`` requests, tenants a and b in turn, each prompt its tenant's
    system prompt and a user turn; served until idle."""
    rng = np.random.default_rng(0)
    system = {t: rng.integers(0, cfg.vocab_size, SYSTEM) for t in "ab"}
    reqs = []
    for i in range(n):
        t = "ab"[i % 2]
        reqs.append(gw.submit(t, np.concatenate(
            [system[t], rng.integers(0, cfg.vocab_size, USER)]),
            max_new_tokens=new))
    assert gw.run_until_idle()
    return reqs


class FakeEvent:
    """A timing event that logs what is done with it; its "device time" is
    the host's clock at ``record``. ``done`` says whether ``query`` finds
    it completed."""
    log = []
    done = False

    def __init__(self, **kw):
        self.t = None

    def record(self, stream=None):
        import time
        self.t = time.perf_counter() * 1e3
        FakeEvent.log.append(("record", recorder.step))

    def query(self):
        FakeEvent.log.append(("query", recorder.step))
        return FakeEvent.done

    def synchronize(self):
        FakeEvent.log.append(("synchronize", recorder.step))

    def elapsed_time(self, other):
        FakeEvent.log.append(("elapsed_time", recorder.step))
        return other.t - self.t


def test_off_keeps_no_record_and_records_no_event(served, rec, monkeypatch):
    FakeEvent.log = []
    rec.enable(event=FakeEvent)
    rec.disable()
    gw = _gateway(served)
    reqs = _serve(gw, served[0])
    assert all(r.finish_reason == "length" for r in reqs)
    got = rec.records()
    assert got.spans == [] and got.counts == []
    assert FakeEvent.log == []


def test_spans_nest_in_their_step_and_carry_the_request(served, rec):
    gw = _gateway(served)
    rec.enable()
    reqs = _serve(gw, served[0])
    rec.disable()
    got = rec.records()
    names = {s.name for s in got.spans}
    assert {"gateway.step", "gateway.monitor", "engine.scrub",
            "engine.admit", "prefill.run", "engine.splice",
            "engine.prepare_writes", "engine.stage", "engine.download",
            "engine.post"} <= names
    by_id = {s.id: s for s in got.spans}
    roots = {s.step: s for s in got.spans if s.name == "gateway.step"}
    assert sorted(roots) == list(range(len(roots)))
    assert all(s.parent < 0 for s in roots.values())
    ids = {r.request_id for r in reqs}
    for s in got.spans:
        if s.name == "gateway.step":
            continue
        root = roots[s.step]
        assert root.start <= s.start <= s.end <= root.end, s
        parent = by_id[s.parent]
        assert parent.step == s.step
        assert parent.start <= s.start and s.end <= parent.end, s
        if s.name in ("engine.admit", "prefill.run", "engine.splice"):
            assert s.request in ids, s
    # each request admitted once: one admission, prefill and splice each
    for name in ("engine.admit", "prefill.run", "engine.splice"):
        assert sorted(s.request for s in got.spans
                      if s.name == name) == sorted(ids)
    assert min(got.self_seconds().values()) >= 0.0
    # the request stamps share the spans' clock
    first = min(s.start for s in got.spans)
    last = max(s.end for s in got.spans)
    for r in reqs:
        assert first <= r.first_token_at <= r.finished_at <= last


def test_self_seconds_subtract_the_children():
    from repro_torch.core.spans import Span
    got = Records([Span(0, "gateway.step", 0.0, 10.0, 0, -1, -1),
                   Span(1, "engine.admit", 1.0, 4.0, 0, 0, 3),
                   Span(2, "prefill.run", 1.5, 3.0, 0, 1, 3),
                   Span(3, "engine.post", 6.0, 7.0, 0, 0, -1)], [])
    assert got.self_seconds() == {0: 6.0, 1: 1.5, 2: 1.5, 3: 1.0}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_prefill_counts_are_exact(served, rec, paged):
    """Prompts of 15 tokens (contexts of 14) pad to the bucket of 16. Paged,
    a tenant's second request admitted beside its first shares the two
    full pages of their system prompt (8 positions): its splice writes
    14 - 8 = 6; dense, every splice writes the whole context."""
    gw = _gateway(served, paged=paged)
    rec.enable()
    reqs = _serve(gw, served[0], n=4)
    rec.disable()
    counts = rec.records().counts
    pos = {c.request: c.value for c in counts
           if c.name == "prefill_positions"}
    written = {c.request: c.value for c in counts
               if c.name == "prefill_written"}
    ids = [r.request_id for r in reqs]
    assert pos == {i: 16 for i in ids}
    shared = SYSTEM // PAGE * PAGE
    assert written == {i: 14 - (shared if paged and k >= 2 else 0)
                       for k, i in enumerate(ids)}
    if paged:
        assert gw.page_stats()["prefix_hits"] == 2 * (SYSTEM // PAGE)


def test_no_event_pair_is_read_inside_a_step(served, rec, monkeypatch):
    """A stand-in event class on the CPU engine (its splices and scrubs
    take pairs): while the steps run, events are only recorded; the
    ring's pairs stay unfinished (``query`` False), so the ring grows
    instead of waiting. Once the window is closed, ``records`` reads
    every pair."""
    monkeypatch.setattr(recorder, "pairs", 2)
    FakeEvent.log, FakeEvent.done = [], False
    gw = _gateway(served)
    rec.enable(event=FakeEvent)
    _serve(gw, served[0])
    rec.disable()
    inside = {op for op, step in FakeEvent.log if step >= 0}
    assert inside <= {"record", "query"}, inside
    assert "query" in inside                 # the ring came round
    n_log = len(FakeEvent.log)
    got = rec.records()
    after = {op for op, _ in FakeEvent.log[n_log:]}
    assert after == {"synchronize", "elapsed_time"}
    timed = [s for s in got.spans if s.device is not None]
    assert {s.name for s in timed} == {"engine.splice", "engine.scrub"}
    assert all(s.device[1] >= s.device[0] for s in timed)
    assert len(rec._rings["cpu"].pairs) >= len(timed)


def test_a_finished_pair_is_read_when_the_ring_comes_round(served, rec,
                                                           monkeypatch):
    monkeypatch.setattr(recorder, "pairs", 2)
    FakeEvent.log, FakeEvent.done = [], True
    gw = _gateway(served)
    rec.enable(event=FakeEvent)
    _serve(gw, served[0])
    rec.disable()
    assert len(rec._rings["cpu"].pairs) == 2        # reused, never grown
    got = rec.records()
    assert all(s.device is not None for s in got.spans
               if s.name in ("engine.splice", "engine.scrub"))
    FakeEvent.done = False


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and events run only "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_decode_replays_and_scrubs_timed_by_events_on_card(cuda, rec,
                                                           monkeypatch):
    cfg = reduced(get_config("smollm-135m"))
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    gw = _gateway((cfg, model, params), device="cuda")
    _serve(gw, cfg, n=2)                    # captures the graphs
    scrub0 = gw.page_stats()["scrub_ms"]
    rec.enable()
    ring = next(iter(rec._rings.values()))
    reads = []
    for name in ("synchronize", "elapsed_time", "wait"):
        real = getattr(torch.cuda.Event, name)

        def logged(self, *a, real=real, name=name):
            if any(self is e for p in ring.pairs for e in p) \
                    or self is ring.anchor:
                reads.append((name, recorder.step))
            return real(self, *a)
        monkeypatch.setattr(torch.cuda.Event, name, logged)
    reqs = _serve(gw, cfg)
    rec.disable()
    assert reads == []                  # no step read or waited on a pair
    got = rec.records()
    assert reads and all(step < 0 for _, step in reads)
    replays = [s for s in got.spans if s.name == "decode.replay"]
    assert replays and all(s.device is not None for s in replays)
    assert all(0.0 < s.device[1] - s.device[0] < 1e3 for s in replays)
    assert any(s.name == "prefill.replay" and s.device for s in got.spans)
    torch.cuda.synchronize()
    assert gw.page_stats()["scrub_ms"] > scrub0
    assert all(r.finish_reason == "length" for r in reqs)
