"""The port's spans and counters on its hot path (``repro_torch.obs``):
the MLP's iterations on both tensor engines, the relational engine, the
kernels' wrappers, the LM training step and the MoE's drop counters.

- off: with no tracer installed and no profiler recording, a run makes no
  ``Span``, no ``record_function`` and no CUDA event;
- the layer map: under a CPU ``torch.profiler`` session the runs leave
  their spans, and each span is a user annotation of the profiler,
  starting within 1 ms of the span's ``t0`` (one clock); with no tracer
  installed, ``obs.profiled()`` keeps the same spans' sums a name and
  their counters, and no span;
- sessions, ``py.gc`` spans, device-valued counters, and no reference
  cycle left by an iteration of either tensor engine;
- the MoE's counters, equal under ``remat="full"`` and ``"none"`` and to a
  count from ``_sort_relation``'s ranks;
- on the card (``-m cuda``; skips without one): the ``kernels.<name>``
  spans number the wrappers' launches, and device-timed spans read
  non-negative milliseconds within their unit's host time and queue.

Imports neither JAX nor the JAX package.
"""
import collections
import dataclasses
import gc
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import MLAConfig
from repro_torch.core import nn2sql
from repro_torch.core.engine import Engine
from repro_torch.nn import moe as M
from repro_torch.nn.model import LM
from repro_torch.obs import tracer as T
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import tree_map

ITERS = 2
ARCH = "deepseek_v2_lite_16b"
#: the relational engine's products and transposes in one iteration of
#: Eqs. 4-11: z_xh, z_ho and Eqs. 8, 10, 11; the transposes of img, a_xh
#: and w_ho
REL_MATMULS, REL_TRANSPOSES = 5, 3


def mlp(device="cpu", rows=24):
    spec = nn2sql.MLPSpec(rows, 8, 6, 3, lr=0.1)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(rows, 8, generator=gen, device=device)
    labels = torch.randint(0, 3, (rows,), generator=gen, device=device)
    y = torch.nn.functional.one_hot(labels, 3).float()
    return (nn2sql.build_graph(spec), nn2sql.init_weights(spec, device=device),
            x, y)


def train_mlp(kind, device="cpu", iters=ITERS):
    graph, w, x, y = mlp(device)
    return nn2sql.train(graph, w, x, y, iters, Engine(kind, device=device))


def moe_lm(remat="full", impl="sort", device="cpu", mla=None):
    cfg = get_config(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, remat=remat,
                              moe=dataclasses.replace(cfg.moe, impl=impl),
                              mla=mla or cfg.mla)
    return LM(cfg, device=device)


def lm_batch(lm, seed=3, rows=4, seq=16, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, lm.cfg.vocab, (rows, seq + 1), generator=gen,
                         device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_lm(remat="full", impl="sort"):
    lm = moe_lm(remat, impl)
    params = lm.init(torch.Generator().manual_seed(0))
    opt = adamw(1e-3)
    step = make_train_step(lm.loss_fn, opt, grad_accum=2)
    return step(params, opt.init(params), lm_batch(lm))


RUNS = {"dense": lambda: train_mlp("dense"),
        "relational": lambda: train_mlp("relational"),
        "train_step": train_lm}


def profiled(run, tracer=None):
    """Run under a CPU profiler session, with ``tracer`` installed if
    given: (``tracer``, else the session's, and the profiler's user
    annotations by name, in order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if tracer is None:
            run()
        else:
            with obs.use(tracer):
                run()
    marks = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            marks[e.name()].append(e.start_ns())
    return tracer or obs.profiled(), marks


def names(tracer) -> collections.Counter:
    """Spans a name, from a tracer's spans or a session's sums."""
    if isinstance(tracer, obs.SessionTracer):
        return collections.Counter({n: t.count
                                    for n, t in tracer.totals.items()
                                    if n != "py.gc"})
    return collections.Counter(s.name for s in tracer.spans
                               if s.name != "py.gc")


@pytest.mark.parametrize("run", RUNS)
def test_off_path_makes_no_span_range_or_event(run, monkeypatch):
    made = collections.Counter()

    def counted(what, cls):
        class Counted(cls):
            def __init__(self, *a, **kw):
                made[what] += 1
                super().__init__(*a, **kw)
        return Counted

    monkeypatch.setattr(T, "Span", counted("span", T.Span))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counted("range", torch.autograd.profiler
                                .record_function))
    monkeypatch.setattr(torch.cuda, "Event", counted("event",
                                                     torch.cuda.Event))
    assert obs.current() is T._NULL and not obs.tracing()
    RUNS[run]()
    gc.collect()
    assert made == {}


@pytest.mark.parametrize("kind", ["dense", "relational"])
def test_mlp_layer_map(kind):
    tr, marks = profiled(lambda: train_mlp(kind), obs.Tracer())
    want = {"nn2sql.iteration": ITERS, "engine.evaluate": ITERS}
    if kind == "relational":
        want.update({"rel.matmul": REL_MATMULS * ITERS,
                     "rel.transpose": REL_TRANSPOSES * ITERS})
    got = names(tr)
    assert {n: got[n] for n in want} == want
    assert set(got) - set(want) <= ({"rel.pivot"} if kind == "relational"
                                    else set())
    units = [s for s in tr.spans if s.name == "nn2sql.iteration"]
    assert [s.attrs["it"] for s in units] == list(range(ITERS))
    assert all(s.attrs["rows"] == 24 for s in units)
    by_id = {s.span_id: s for s in tr.spans}
    for s in tr.spans:
        if s.name == "rel.matmul":
            assert s.attrs["tuples"] > 0 and len(s.attrs["shape"]) == 3
        if s.name == "engine.evaluate":
            assert s.attrs["kind"] == kind
            assert by_id[s.parent_id].name == "nn2sql.iteration"
    assert_on_the_profilers_clock(tr, marks)


def assert_on_the_profilers_clock(tr, marks):
    """Each span is a profiler annotation of its name, whose start lies
    within 1 ms of the span's t0."""
    spans = collections.defaultdict(list)
    for s in tr.spans:
        spans[s.name].append(s.t0)
    for name, t0s in spans.items():
        starts = sorted(marks[name])
        assert len(starts) == len(t0s), name
        for t0, start in zip(sorted(t0s), starts):
            assert abs(start * 1e-9 - t0) < 1e-3, (name, start * 1e-9 - t0)


def test_train_step_layer_map():
    tr, marks = profiled(train_lm, obs.Tracer())
    assert {n: c for n, c in names(tr).items()} == {
        "train.step": 1, "train.microbatch": 2, "train.forward": 2,
        "train.backward": 2, "train.grad_scale": 1, "train.clip": 1,
        "train.update": 1}
    step, = [s for s in tr.spans if s.name == "train.step"]
    assert step.attrs == {"step": 0, "tokens": 4 * 16}
    by_id = {s.span_id: s for s in tr.spans}
    for s in tr.spans:
        if s.name in ("train.forward", "train.backward"):
            assert by_id[s.parent_id].name == "train.microbatch"
        if s.name in ("train.microbatch", "train.clip", "train.update"):
            assert s.parent_id == step.span_id
    counters = tr.counters
    assert counters["moe.assignments"] > 0
    assert 0 <= counters["moe.dropped"] < counters["moe.assignments"]
    assert_on_the_profilers_clock(tr, marks)


@pytest.mark.parametrize("run", RUNS)
def test_the_session_keeps_sums_not_spans(run):
    """With no tracer installed, the session's sums match the spans an
    installed tracer keeps of the same run, and no span is kept."""
    kept, _ = profiled(RUNS[run], obs.Tracer())
    session, _ = profiled(RUNS[run])
    assert isinstance(session, obs.SessionTracer) and session.spans == []
    assert names(session) == names(kept)
    for name, t in session.totals.items():
        spans = [s for s in kept.spans if s.name == name]
        assert t.seconds >= 0 and t.device_ms is None
        for attr in ("it", "rows", "tuples"):
            values = [s.attrs[attr] for s in spans if attr in s.attrs]
            assert t.attrs.get(attr) == (sum(values) if values else None)
    assert session.counters == kept.counters


def test_a_new_session_keeps_only_its_own_spans():
    first, _ = profiled(lambda: train_mlp("dense", iters=2))
    second, _ = profiled(lambda: train_mlp("dense", iters=3))
    assert second is not first and obs.profiled() is second
    assert names(second)["nn2sql.iteration"] == 3
    assert names(first)["nn2sql.iteration"] == 2


def test_an_installed_tracer_takes_the_spans_from_the_session():
    tr = obs.Tracer()
    with obs.use(tr), profile(activities=[ProfilerActivity.CPU]):
        train_mlp("dense")
    assert names(tr)["nn2sql.iteration"] == ITERS
    assert obs.profiled().spans == ()


def many_threads(tracer=None, each=300):
    """Nested spans and a counter from more threads than cores, switching
    often, under ``tracer`` (else under a profiler session): the number of
    workers."""
    workers = 2 * (os.cpu_count() or 2) + 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(each):
            with obs.span("test.outer"), obs.span("test.inner"):
                obs.inc("n")
    try:
        with (obs.use(tracer) if tracer is not None
              else profile(activities=[ProfilerActivity.CPU])):
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    return workers


def test_spans_from_many_threads_are_all_kept_with_unique_ids():
    """Spans publish without the tracer's lock (ids from one counter, one
    ``list.append``): more threads than cores, switching often, lose
    none."""
    tr = obs.Tracer()
    workers, each = many_threads(tr), 300
    assert len(tr.spans) == 2 * workers * each
    assert len({s.span_id for s in tr.spans}) == len(tr.spans)
    assert tr.counters["n"] == workers * each
    assert all(s.path == "test.outer/test.inner"
               for s in tr.spans if s.name == "test.inner")


def test_a_session_sums_spans_from_many_threads():
    workers = many_threads(each=100)
    session = obs.profiled()
    assert names(session) == {"test.outer": 100 * workers,
                              "test.inner": 100 * workers}
    assert session.counters["n"] == 100 * workers


@pytest.mark.parametrize("kind", ["dense", "relational"])
def test_an_iteration_leaves_no_reference_cycle(kind):
    """The engines' intermediates are freed when an evaluation returns,
    not at Python's next cyclic collection (which set the MLP's memory
    peak by where it fell among the iterations)."""
    train_mlp(kind)
    gc.collect()
    gc.disable()
    try:
        train_mlp(kind)
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_a_collection_under_the_profiler_is_a_gc_span():
    tr = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]), obs.use(tr):
        with obs.span("test.outer"):
            gc.collect()
    spans = [s for s in tr.spans if s.name == "py.gc"]
    assert spans and spans[-1].attrs["generation"] == 2
    assert "collected" in spans[-1].attrs
    assert spans[-1].path == "test.outer/py.gc"


def test_counters_sum_tensors_and_read_numbers():
    tr = obs.Tracer()
    with obs.use(tr):
        obs.inc("n", torch.tensor(3))
        obs.inc("n", torch.tensor(4))
        obs.inc("k", 2)
    assert tr.counters == {"n": 7, "k": 2}
    assert isinstance(tr.counters["n"], int)


def test_a_session_holds_no_tensor_once_it_ends():
    """Its device-valued counters are numbers from the profiler's stop on:
    the session kept for ``obs.profiled()`` holds no device memory."""
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("test.unit"):
            obs.inc("n", torch.tensor(3))
            obs.inc("n", torch.tensor(4))
    session = obs.profiled()
    assert session._counters == {"n": 7} and session.counters == {"n": 7}
    assert not isinstance(session._counters["n"], torch.Tensor)


def test_the_default_clock_is_the_profilers():
    tr = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.use(tr), obs.span("test.clock"):
            pass
    start = [e.start_ns() for e in prof.profiler.kineto_results.events()
             if e.name() == "test.clock"]
    assert len(start) == 1
    assert abs(start[0] * 1e-9 - tr.spans[0].t0) < 1e-3


def direct_drops(lm, params, batch, grad_accum=2):
    """(assignments, dropped) over each microbatch's forward, from the
    ranks ``_sort_relation`` gives each routed assignment."""
    seen = [0, 0]
    route = M._route

    def logged(p, x, cfg):
        gates, idx, aux = route(p, x, cfg)
        cap = M._capacity(x.shape[-2], cfg)
        _, _, pos = M._sort_relation(idx, cap, cfg.n_experts)
        seen[0] += pos.numel()
        seen[1] += int((pos >= cap).sum())
        return gates, idx, aux

    n = batch["tokens"].shape[0] // grad_accum
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(M, "_route", logged)
        for i in range(grad_accum):
            lm.forward(params, {k: v[i * n:(i + 1) * n]
                                for k, v in batch.items()})
    return seen


@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_moe_counts_once_under_remat(impl):
    lm = moe_lm("none", impl)
    params = lm.init(torch.Generator().manual_seed(0))
    batch = lm_batch(lm)
    want = direct_drops(lm, params, batch)
    assert want[1] > 0
    for remat in ("none", "full"):
        lm = moe_lm(remat, impl)
        opt = adamw(1e-3)
        p = tree_map(torch.clone, params)
        step = make_train_step(lm.loss_fn, opt, grad_accum=2)
        tr = obs.Tracer()
        with obs.use(tr):
            step(p, opt.init(p), batch)
        c = tr.counters
        assert [c["moe.assignments"], c["moe.dropped"]] == want, remat


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels' spans live in their "
                    "card wrappers")
    return torch.device("cuda")


def launches():
    from repro_torch.kernels import (flash_attention, fused_sigmoid_matmul,
                                     moe_dispatch, onehot_embed,
                                     relational_matmul, rwkv6_scan,
                                     tuple_dot)
    fns = [relational_matmul.relational_matmul,
           fused_sigmoid_matmul.fused_sigmoid_matmul,
           onehot_embed.onehot_embed, moe_dispatch.moe_dispatch,
           flash_attention.flash_attention,
           flash_attention.flash_attention_bwd, tuple_dot.tuple_dot,
           rwkv6_scan.rwkv6_scan, rwkv6_scan.rwkv6_scan_bwd]
    return {"kernels." + f.__name__: f.launches for f in fns}


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["dense", "relational", "train_step"])
def test_kernel_spans_count_launches_and_device_times_fit(cuda, run):
    if run == "train_step":
        # MLA's heads at a size the flash kernels take: q/k 32, v 32
        lm = moe_lm("full", "sort", cuda,
                    MLAConfig(kv_lora=32, d_nope=24, d_rope=8, d_v=32))
        params = lm.init(torch.Generator(device=cuda).manual_seed(0))
        opt = adamw(1e-3)
        step = make_train_step(lm.loss_fn, opt, grad_accum=2)
        state = opt.init(params)
        batch = lm_batch(lm, device=cuda, seq=64)
        step(params, state, batch)                      # warm: builds
        unit_name = "train.step"

        def work():
            step(params, state, batch)
    else:
        graph, w, x, y = mlp(cuda, rows=2000)
        engine = Engine(run, device=cuda)
        nn2sql.train(graph, w, x, y, 1, engine)         # warm: builds
        unit_name = "nn2sql.iteration"

        def work():
            nn2sql.train(graph, w, x, y, ITERS, engine)
    torch.cuda.synchronize()
    before = launches()
    tr = obs.Tracer()
    with obs.use(tr):
        work()
        torch.cuda.synchronize()
        done = obs.epoch_clock()
    counts = names(tr)
    delta = {k: v - before[k] for k, v in launches().items()}
    assert {k: counts[k] for k in delta} == delta
    assert sum(delta.values()) > 0
    resorted = sum(bool(s.attrs.get("resorted")) for s in tr.spans
                   if s.name == "kernels.relational_matmul")
    assert counts["kernels.status_wait"] == (
        delta["kernels.relational_matmul"] + resorted
        + delta["kernels.moe_dispatch"] + delta["kernels.onehot_embed"])
    units = [s for s in tr.spans if s.name == unit_name]
    assert units
    first = min(s.t0 for s in units)
    timed = [s for s in tr.spans if s.device_ms is not None]
    assert {s.name for s in timed} == (
        {"train.forward", "train.backward"} if run == "train_step"
        else set())
    for s in timed:
        assert 0 <= s.device_ms <= (done - first) * 1e3, s.name
    if run != "dense":
        assert counts["kernels.launch"] > 0
