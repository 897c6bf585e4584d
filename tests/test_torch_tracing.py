"""The port's tracer (``repro_torch.tracing``) on the CPU, on smoke configs.

* Off (the default), a ``generate`` makes no span, no CUDA event and no
  profiler range, even under a running profiler; its tokens equal those of
  a call traced.
* On, a call's spans form one tree: ``engine.generate`` over the prefill's
  ``step.capture`` (a layout's first call) or ``step.replay``, every
  step's ``engine.sample`` and every decode step's capture or replay (the
  Engine calls the decode step after each token, the last one's too), all
  with the root's call id; and a profiled call shows each span as a
  ``repro_torch.<name>`` range.
* The counters: a new prompt length captures a new prefill and evicts the
  last; a captured step (through a stand-in graph, as on the card) counts
  its capture and its replays.
* A train step of two microbatches: two ``train.grad`` spans and one
  ``train.update`` under one ``train.step``, the update still called
  through ``optimizer.update``.
* ``launch/serve.py --trace`` prints the spans and the counters.

Marked ``cuda`` (skipped without a card): the events' times on the card are
positive, nest as the spans do, and sit on the tracer's one clock.  This
file imports no JAX, so it runs on the card as it is.
"""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.serve import Engine
from repro_torch.serve.graph import CapturedDecode
from repro_torch.train import OptConfig, init_state, make_train_step, optimizer

ARCHS = ["stablelm_12b", "mamba2_2p7b"]
PROMPT = {"stablelm_12b": (8, 12), "mamba2_2p7b": (16, 32)}  # SSM: whole smoke chunks of 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and nothing held."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def engine(arch, device="cpu", dtype="float32", max_len=48):
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    model = get_model(cfg).init(torch.Generator(device=device).manual_seed(0), device=device)
    return Engine(model, max_len=max_len, device=device)


def prompts(eng, B, S, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, eng.cfg.vocab, (B, S), generator=g).to(eng.device)}


class Counting:
    """Counts the objects a tracer may make: spans, CUDA events, profiler
    ranges."""

    def __init__(self, monkeypatch):
        self.n = {"span": 0, "event": 0, "range": 0}
        span, event = tracing.Span, torch.cuda.Event
        rf = torch.autograd.profiler.record_function
        counts = self.n

        class CountedSpan(span):
            __slots__ = ()

            def __init__(self, *a, **kw):
                counts["span"] += 1
                super().__init__(*a, **kw)

        def counted(kind, make):
            def new(*a, **kw):
                counts[kind] += 1
                return make(*a, **kw)
            return new

        monkeypatch.setattr(tracing, "Span", CountedSpan)
        monkeypatch.setattr(torch.cuda, "Event", counted("event", event))
        monkeypatch.setattr(torch.autograd.profiler, "record_function", counted("range", rf))


@pytest.mark.parametrize("arch", ARCHS)
def test_off_makes_no_span_event_or_range_and_tokens_equal_on(arch, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    eng = engine(arch)
    b = prompts(eng, 2, PROMPT[arch][0])
    eng.generate(b, 2)  # the layouts' first calls
    made = Counting(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        off = eng.generate(b, 4)
    assert made.n == {"span": 0, "event": 0, "range": 0}
    assert tracing.drain() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing.traced():
        on = eng.generate(b, 4)
    spans = tracing.drain()
    # a root, a prefill, 4 samples and 4 decode steps; no card, no events
    assert made.n == {"span": 10, "event": 0, "range": 10}
    assert len(spans) == 10
    names = {e.name for e in prof.events()}
    assert {"repro_torch.engine.generate", "repro_torch.engine.sample",
            "repro_torch.step.replay"} <= names
    np.testing.assert_array_equal(off.tokens, on.tokens)


def tree_of(spans):
    (root,) = [s for s in spans if s.name == "engine.generate"]
    assert root.parent is None and root.call == root.id
    assert all(s.call == root.id for s in spans)
    assert all(s.parent == root.id for s in spans if s is not root)
    assert len({s.id for s in spans}) == len(spans)
    kids = sorted((s for s in spans if s is not root), key=lambda s: s.host[0])
    return root, [(s.name, s.attrs.get("kind")) for s in kids]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_calls_spans_form_one_tree(arch):
    eng = engine(arch)
    B, S, n = 2, PROMPT[arch][0], 3
    for first in (True, False):
        with tracing.traced():
            eng.generate(prompts(eng, B, S), n)
        spans = tracing.drain()
        root, kids = tree_of(spans)
        assert root.attrs == {"B": B, "prompt": S, "n_steps": n}
        made = "step.capture" if first else "step.replay"
        decode = [(made, "decode")] + [("step.replay", "decode")] * (n - 1)
        want = [(made, "prefill")] + [x for d in decode for x in (("engine.sample", None), d)]
        assert kids == want
        for s in spans:
            assert 0 <= s.host[0] <= s.host[1] <= root.host[1] and s.device is None


@pytest.mark.parametrize("arch", ARCHS)
def test_a_new_prompt_length_captures_a_prefill_and_evicts_the_last(arch):
    eng = engine(arch)
    before = tracing.counters()
    for S in PROMPT[arch]:
        eng.generate(prompts(eng, 2, S), 2)
    eng.generate(prompts(eng, 2, PROMPT[arch][1]), 2)
    after = tracing.counters()
    delta = {k: after[k] - before[k] for k in tracing.COUNTERS}
    assert delta["captures.prefill"] == 2 and delta["prefill_evictions"] == 1
    assert delta["captures.decode"] == 1  # one decode layout: batch 2, max_len 48
    assert delta["replays.prefill"] == 1 and delta["replays.decode"] == 5
    assert delta["capture_s.prefill"] > 0 and delta["capture_s.decode"] > 0
    assert len(eng._prefills) == 1


class StandInGraph:
    """A graph on the CPU: ``capture`` runs the step's Python once, as a
    CUDA capture does, and ``replay`` only counts."""

    def __init__(self):
        self.replays = 0

    def warm_up(self, body):
        return body()

    def capture(self, body):
        return body()

    def replay(self):
        self.replays += 1


def test_a_captured_step_counts_its_capture_and_replays():
    def step(state, tokens):
        return tokens.float()[:, None], {**state, "pos": state["pos"] + 1}

    state = {"pos": torch.zeros(2, dtype=torch.int32)}
    tok = torch.ones(2, 1, dtype=torch.long)
    captured = CapturedDecode(step, state, StandInGraph)
    before = tracing.counters()
    with tracing.traced():
        captured(state, tok)
        for _ in range(3):
            captured(captured.state, tok)
    after = tracing.counters()
    assert captured.captured and captured.replays == 3 and captured.graph.replays == 3
    assert [(s.name, s.attrs) for s in tracing.drain()] == \
        [("step.capture", {"kind": "decode"})] + [("step.replay", {"kind": "decode"})] * 3
    assert after["captures.decode"] - before["captures.decode"] == 1
    assert after["replays.decode"] - before["replays.decode"] == 3
    assert set(k for k in after if k.startswith("launches.")) == \
        {"launches.flash_prefill", "launches.flash_decode", "launches.ssd_intra_chunk"}


def test_a_train_step_of_two_microbatches(monkeypatch):
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    ocfg = OptConfig(lr=1e-3, warmup_steps=1)
    state = init_state(cfg, ocfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    update = optimizer.update

    def wrapped(*a, **kw):  # as a benchmark wraps the module attribute
        calls.append(1)
        return update(*a, **kw)

    monkeypatch.setattr(optimizer, "update", wrapped)
    step = make_train_step(cfg, ocfg, microbatches=2)
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=torch.Generator().manual_seed(2))
    with tracing.traced():
        state, metrics = step(state, {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})
    spans = tracing.drain()
    assert calls == [1] and torch.isfinite(metrics["loss"])
    (root,) = [s for s in spans if s.name == "train.step"]
    kids = sorted((s for s in spans if s is not root), key=lambda s: s.host[0])
    assert [(s.name, s.attrs) for s in kids] == \
        [("train.grad", {"i": 0}), ("train.grad", {"i": 1}), ("train.update", {})]
    assert all(s.parent == root.id and s.call == root.id for s in kids)


def test_the_launcher_prints_spans_and_counters(capsys):
    serve.main(["--arch", "mamba2_2p7b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "3", "--trace"])
    out = capsys.readouterr().out
    assert "generated=3 tokens/request" in out  # the lines without --trace stay
    lines = [line.split() for line in out.splitlines()]
    rows = {r[0]: r[1:] for r in lines if len(r) == 4}
    assert rows["engine.generate"][0] == "1" and rows["engine.sample"][0] == "3"
    assert rows["step.capture.prefill"][0] == "1" and rows["step.replay.decode"][0] == "2"
    assert rows["engine.sample"][2] == "-"  # no device time on the CPU
    counters = {r[0]: float(r[1]) for r in lines if len(r) == 2 and r[0] in tracing.COUNTERS}
    assert set(counters) == set(tracing.COUNTERS) and counters["captures.prefill"] >= 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def within(inner, outer, slack=1e-6):
    return outer[0] - slack <= inner[0] <= inner[1] <= outer[1] + slack


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_event_times_on_the_card_are_positive_nested_and_on_one_clock(cuda, arch):
    eng = engine(arch, device="cuda", dtype="bfloat16")
    b = prompts(eng, 2, PROMPT[arch][0])
    for _ in range(2):  # a call that captures, then one that replays
        with tracing.traced():
            eng.generate(b, 4)
        spans = tracing.drain()
        root, _ = tree_of(spans)
        err = tracing.anchor_error_s
        assert 0 <= err < 0.01
        for s in spans:
            assert s.device is not None and 0 < s.device[0] <= s.device[1]
            assert within(s.device, root.device)
            # an event runs no earlier than the host records it
            assert s.device[0] >= s.host[0] - err - 1e-6
        replays = [s for s in spans if s.name == "step.replay"]
        assert all(s.device[1] > s.device[0] for s in replays)
