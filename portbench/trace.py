"""The traced run: ranges around calls into the program's layers, put
there from the benchmark's own files, and the reduction of
``torch.profiler``'s events to per-layer readings.

A range is a ``record_function`` span named ``pb/<metric>`` around a call
(a function or method of the program, patched for the traced run only),
and around each autograd node that the call created, while that node's
backward runs.  A device operation belongs to a range when the host op
that launched it (the profiler's correlation) started inside the range on
the same thread; the device time of a metric is the sum over its
operations.  The work of a call (``counts``) is charged when the call
returns, the backward's when its first node runs.

The profiler's own ``device_time_total`` of the same ranges is not used:
with PyTorch 2.11 on an H100 it read 2.0-2.95 times this attribution, more
device time than the window held (a ``RelTensor.matmul`` range 86.6 ms of
a 55 ms iteration)."""
from __future__ import annotations

import bisect
import collections
import dataclasses
import importlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "pb/"
WINDOW = PREFIX + "window"


def _tensors(obj, out: list) -> list:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def created_nodes(out, inputs) -> list:
    """The autograd nodes between ``out`` and ``inputs``: those that the
    call which took ``inputs`` and returned ``out`` created, roots
    first."""
    stop = {t.grad_fn for t in _tensors(inputs, []) if t.grad_fn is not None}
    todo = [t.grad_fn for t in _tensors(out, []) if t.grad_fn is not None]
    seen, nodes = set(), []
    while todo:
        node = todo.pop(0)
        if (node is None or node in seen or node in stop
                or type(node).__name__ == "AccumulateGrad"):
            continue
        seen.add(node)
        nodes.append(node)
        todo.extend(f for f, _ in node.next_functions)
    return nodes


class _NodeRange:
    """A range open while one autograd node runs; the first node of a call
    charges the call's backward work."""

    def __init__(self, probes, metric: str, work: float):
        self.probes, self.metric, self.work = probes, metric, work
        self.span = None

    def pre(self, *_):
        if self.probes.active:
            self.probes.work[self.metric] += self.work
        self.work = 0.0
        self.span = record_function(PREFIX + self.metric)
        self.span.__enter__()

    def post(self, *_):
        self.span.__exit__(None, None, None)


class Probes:
    """The patched calls of a traced run, and the work they counted while
    ``active``."""

    def __init__(self):
        self.work: dict[str, float] = collections.defaultdict(float)
        self.calls: collections.Counter = collections.Counter()
        self.active = False
        self._undo: list = []

    def wrap(self, owner, attr: str, metric: str, work_fn=None,
             backward: bool = False) -> None:
        raw = owner.__dict__[attr] if isinstance(owner, type) else \
            getattr(owner, attr)
        static = isinstance(raw, staticmethod)
        fn = raw.__func__ if static else raw
        probes = self

        def wrapped(*args, **kwargs):
            with record_function(PREFIX + metric):
                out = fn(*args, **kwargs)
            if not probes.active:
                return out
            fwd, bwd = work_fn(args, kwargs, out) if work_fn else (0.0, 0.0)
            probes.work[metric] += fwd
            probes.calls[metric] += 1
            if backward and torch.is_grad_enabled():
                for i, node in enumerate(created_nodes(out, (args, kwargs))):
                    span = _NodeRange(probes, metric, bwd if i == 0 else 0.0)
                    node.register_prehook(span.pre)
                    node.register_hook(span.post)
            return out

        new = staticmethod(wrapped) if static else wrapped
        if dataclasses.is_dataclass(owner) and not isinstance(owner, type):
            object.__setattr__(owner, attr, new)
        else:
            setattr(owner, attr, new)
        self._undo.append((owner, attr, raw))

    def install(self, metric: str, calls: dict, objects: dict) -> None:
        """Patch each target of ``calls`` ({target: (work function name in
        ``counts`` or None, backward)}) for ``metric``.  A target is
        ``module:Qual.name`` or ``@object.attr``, an object the driver
        names in ``objects``."""
        from . import counts
        for target, (work, backward) in calls.items():
            if target.startswith("@"):
                name, attr = target[1:].rsplit(".", 1)
                owner = objects[name]
            else:
                module, qual = target.split(":")
                owner = importlib.import_module(module)
                *path, attr = qual.split(".")
                for p in path:
                    owner = getattr(owner, p)
            self.wrap(owner, attr, metric,
                      getattr(counts, work) if work else None, backward)

    def remove(self) -> None:
        for owner, attr, raw in reversed(self._undo):
            if dataclasses.is_dataclass(owner) and not isinstance(owner, type):
                object.__setattr__(owner, attr, raw)
            else:
                setattr(owner, attr, raw)
        self._undo.clear()


@dataclasses.dataclass
class Reading:
    """What one traced window shows."""
    window_s: float
    busy_s: float
    range_s: dict            # metric -> device seconds inside its ranges
    device_ops: list         # [[name, seconds], ...], the 10 largest
    idle_gaps: list          # [[host op, seconds], ...], the 10 largest
    n_device_ops: int


def _is_cuda(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def reduce_events(events, metrics) -> Reading:
    """``events``: the profiler's kineto events of one session holding a
    ``WINDOW`` range."""
    ranges = collections.defaultdict(list)     # (metric, thread) -> spans
    launches = collections.defaultdict(list)   # CUPTI correlation -> (start, tid)
    ops = collections.defaultdict(list)        # op correlation -> (start, tid)
    host = collections.defaultdict(list)       # tid -> host ops
    device = []
    window = None
    for e in events:
        if _is_cuda(e):
            if not e.is_user_annotation():
                device.append(e)
            continue
        start, end, tid = e.start_ns(), e.end_ns(), e.start_thread_id()
        name = e.name()
        if e.is_user_annotation() and name == WINDOW:
            window = (start, end, tid)
            continue
        if e.is_user_annotation() and name.startswith(PREFIX):
            ranges[(name[len(PREFIX):], tid)].append((start, end))
        if e.correlation_id():
            # the runtime's and the driver's calls carry CUPTI's
            # correlation, every other host op its own id, which a device
            # operation names as the op that launched it
            table = launches if name.startswith("cu") else ops
            table[e.correlation_id()].append((start, tid))
        host[tid].append((start, end, name))
    if window is None:
        raise RuntimeError("the profiler holds no window range")
    w0, w1, _ = window
    spans = {}
    for key, lst in ranges.items():
        lst.sort()
        spans[key] = ([s for s, _ in lst], lst, max(e - s for s, e in lst))

    def inside(metric, start, tid) -> bool:
        key = (metric, tid)
        if key not in spans:
            return False
        starts, lst, longest = spans[key]
        i = bisect.bisect_right(starts, start) - 1
        while i >= 0 and starts[i] >= start - longest:
            if lst[i][1] >= start:
                return True
            i -= 1
        return False

    range_s = dict.fromkeys(metrics, 0.0)
    busy = []
    by_name = collections.defaultdict(float)
    for e in device:
        s, t = e.start_ns(), e.end_ns()
        if s < w0 or s > w1:
            continue
        t = min(t, w1)
        busy.append((s, t))
        by_name[e.name()] += (t - s) / 1e9
        launched = (launches.get(e.correlation_id(), [])
                    + ops.get(e.linked_correlation_id(), []))
        for metric in metrics:
            if any(inside(metric, ls, tid) for ls, tid in launched):
                range_s[metric] += (t - s) / 1e9
    busy.sort()
    merged = []
    for s, t in busy:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_ns = sum(t - s for s, t in merged)
    gaps = []
    edge = w0
    for s, t in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    idle = collections.defaultdict(float)
    for name, ns in _what_the_host_did(gaps, host):
        idle[name] += ns / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Reading(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                   range_s=range_s, device_ops=top(by_name),
                   idle_gaps=top(idle), n_device_ops=len(busy))


def _innermost(gaps, ops):
    """For each gap, the innermost of ``ops`` (one thread's, which nest)
    open at the gap's start, or None: one sweep with a stack."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    stack, i, out = [], 0, []
    for s, _ in gaps:
        while i < len(ops) and ops[i][0] <= s:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < s:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _what_the_host_did(gaps, host: dict):
    """(name of the innermost host op open at the gap's start, on any
    thread: the one that started last; the gap's length) for each gap."""
    per_thread = [_innermost(gaps, ops) for ops in host.values()]
    for k, (s, t) in enumerate(gaps):
        open_ops = [ops[k] for ops in per_thread if ops[k] is not None]
        op = max(open_ops, key=lambda o: o[0]) if open_ops else None
        yield (op[2] if op else "(no host op)"), t - s


def traced(run_window, metrics, device="cuda"):
    """Run ``run_window()`` (which returns its own result and ends with a
    synchronize) under the profiler inside a ``WINDOW`` range, after three
    groups of marker kernels: a session on this card has at times lost
    its first device events.  Returns (result, Reading); tries once more
    if the window holds no device operation."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]
                     + [ProfilerActivity.CUDA] * cuda) as prof:
            for _ in range(3 * cuda):
                for _ in range(3):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(0.01)
            with record_function(WINDOW):
                result = run_window()
        reading = reduce_events(prof.profiler.kineto_results.events(),
                                metrics)
        if reading.n_device_ops or not cuda:
            return result, reading
    return result, reading
