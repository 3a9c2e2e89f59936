"""Tracing and profiling (counterpart of ``facerec_tpu/utils/profiling.py``,
extended into the port's one tracing system):

  * the registry: spans and counters that the serve and train paths record
    where their work happens, off by default (``enable``, ``disable``,
    ``enabled``, ``reset``, ``snapshot``; ``self_times`` of its spans);
  * :class:`StageTimer` — wall time per named stage, synchronising on the
    device the stage's result lives on, so asynchronous CUDA work is inside
    the stage it belongs to; each stage is a ``span``;
  * :func:`trace` — a ``torch.profiler`` capture of the CPU and, on a card,
    CUDA activity, written as a Chrome trace;
  * :func:`timed_call` — steady-state timing with one salted argument, so
    no call repeats its inputs.

The registry keeps, in memory and for the whole process:

  * host spans (``span``): name, start and end on ``time.perf_counter``,
    the enclosing span, the request they belong to and their attributes.
    ``request`` opens a request (one ``identify`` call, one train step):
    every span inside it, on any clock, carries its id. Besides the
    registry, every span but a request's opens a ``record_function`` range
    whenever a torch profiler is active, with tracing on or off, so the
    profiler's trace names the program's stages. With tracing off and no
    profiler a span is one flag check and a shared null context;
  * counters (``count``), and device counters (``device_count``) that a
    step adds to in stream order on the card and the host reads later;
  * device spans (``device_span``): a start and an end that the card
    itself stamps in stream order, with ``csrc/trace_stamp.cu`` (its
    ``%globaltimer`` into a ring of ``RING_SLOTS`` slots in device memory,
    at a slot a device-side cursor advances), so they hold inside a
    captured CUDA graph: every replay stamps anew. A graph captured with
    tracing off holds no stamp and no counter: the serve and train steps
    make tracing part of their capture key. The host reads a ring only where
    the program waits for the card already (``harvest``, after
    ``identify``'s read-back) and in ``snapshot``; stamps past the ring's
    end are counted as ``trace.ring_overflow``. The kernel is built at the
    first ``enable`` on a card. On the CPU, where a step is synchronous, a
    device span is a host span;
  * ``python.gc`` spans, one for each collection of the garbage collector
    (attribute ``generation``), recorded and ranged as a span is.

Span and counter names (the port's interface, ``PERF.md`` section 3):
``serve.request`` (a request) > ``serve.upload``, ``serve.launch``,
``serve.readback``, ``serve.decode`` (host); ``serve.step.detect``,
``.align``, ``.embed``, ``.match`` (device); ``serve.valid_slots`` and
``detect.nms_rounds`` (counters); ``train.step`` (a request) >
``train.step.launch`` (host); ``train_step.forward``, ``.backward``,
``.grads``, ``.optimizer`` and ``bn.gather`` (device, attribute ``index``:
the data-parallel BatchNorm's order in the forward pass);
``train.feed.wait``, ``train.feed.stage`` (host) and ``train.feed.depth``
(counter).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import itertools
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

RING_SLOTS = 65536  # (code, time) pairs a card's ring holds between two reads
COUNTER_SLOTS = 63  # device counters a card holds; the head's first word is the cursor
_HEAD = 1 + COUNTER_SLOTS
_START, _END, _MARK = 0, 1, 2  # a stamp's kind, in its code's low two bits


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree: Any) -> Any:
    """Wait for every CUDA device that holds a tensor of ``tree`` (nested
    lists, tuples and dicts); CPU tensors are ready when returned."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


class _Null:
    """The shared context of a span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Frame:
    """An open span on a thread's stack: its id (None for a device span,
    whose id the harvest gives) and how many spans of each name it has
    opened (``numbered``)."""

    __slots__ = ("id", "kids")

    def __init__(self, span_id: int | None):
        self.id = span_id
        self.kids: dict[str, int] = {}


class _Ring:
    """A card's ring: one int64 buffer of the cursor, ``COUNTER_SLOTS``
    counters and ``RING_SLOTS`` (code, time) pairs."""

    def __init__(self, device: torch.device):
        from facerec_torch import build

        self.device = device
        self.buf = torch.zeros(_HEAD + 2 * RING_SLOTS, dtype=torch.int64, device=device)
        self.counters: list[str] = []
        self.t0_ns: int | None = None  # the first stamp read: the ring's clock starts there
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        self._launch = build.function("trace_stamp", "trace_stamp_launch", (p, p, ll, ll, p))
        self._check = build.check

    def stamp(self, code: int) -> None:
        base = self.buf.data_ptr()
        with torch.cuda.device(self.device):
            err = self._launch(base, base + 8 * _HEAD, RING_SLOTS, code,
                               torch.cuda.current_stream(self.device).cuda_stream)
        self._check(err, "trace_stamp")

    def add(self, name: str, value: torch.Tensor) -> None:
        if name not in self.counters:
            if len(self.counters) == COUNTER_SLOTS:
                raise ValueError(f"a card holds {COUNTER_SLOTS} device counters; "
                                 f"{name!r} is one more")
            self.counters.append(name)
        self.buf[1 + self.counters.index(name)].add_(value)

    def read(self) -> tuple[list[int], int, list[list[int]]]:
        """(counters, stamps made, the stamps kept as [code, ns]) since the
        last read, which this one zeroes in stream order. Call it where the
        card has finished the stream's work (a read-back) or after a
        synchronise."""
        with torch.cuda.device(self.device):
            head = self.buf[:_HEAD].cpu().tolist()
            n = min(head[0], RING_SLOTS)
            body = self.buf[_HEAD:_HEAD + 2 * n].view(n, 2).cpu().tolist() if n else []
            self.buf[:_HEAD].zero_()
        return head[1:], head[0], body


def _card(device: torch.device) -> torch.device:
    """A CUDA device with its index (the current card's where it has none)."""
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


class Registry:
    """The process's spans and counters (module docstring); ``REGISTRY``
    is the one instance, reached through the module's functions."""

    def __init__(self):
        self.on = False
        self._spans: list[tuple] = []  # (id, name, start, end, parent, request, clock, attrs)
        self._counts: list[tuple] = []  # (name, value, request, time)
        self._ids = itertools.count(1)
        self._local = threading.local()  # .stack of _Frame, .request
        self._rings: dict[torch.device, _Ring] = {}
        self._codes: dict[tuple, int] = {}  # (name, attrs) of a device span -> its code
        self._names: list[tuple[str, dict]] = []
        self._lock = threading.Lock()
        self._gc: tuple | None = None  # the open collection: (start, range, parent, generation)

    # -- what each thread has open ------------------------------------------------------
    def _stack(self) -> list[_Frame]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _request(self) -> int | None:
        return getattr(self._local, "request", None)

    def _parent(self) -> int | None:
        for f in reversed(self._stack()):
            if f.id is not None:
                return f.id
        return self._request()

    def _numbered(self, name: str, attrs: dict) -> dict:
        """``attrs`` with ``index``: the spans of ``name`` the innermost
        open span has opened before this one."""
        s = self._stack()
        if not s:
            return attrs
        k = s[-1].kids.get(name, 0)
        s[-1].kids[name] = k + 1
        return {**attrs, "index": k}

    # -- recording ----------------------------------------------------------------------
    def add_span(self, name: str, start: float, end: float, parent: int | None,
                 attrs: dict, span_id: int | None = None) -> None:
        sid = next(self._ids) if span_id is None else span_id
        self._spans.append((sid, name, start, end, parent, self._request(), "host", attrs))

    def count(self, name: str, value: float) -> None:
        self._counts.append((name, value, self._request(), time.perf_counter()))

    def ring(self, device: torch.device) -> _Ring:
        device = _card(device)
        r = self._rings.get(device)
        if r is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"tracing has no ring on {device}: enable() before a "
                                   "CUDA graph is captured there")
            r = self._rings[device] = _Ring(device)
        return r

    def code(self, name: str, attrs: dict) -> int:
        """The code of a device span of ``name`` and ``attrs``, its kind's
        two bits left 0."""
        key = (name, tuple(sorted(attrs.items())))
        c = self._codes.get(key)
        if c is None:
            with self._lock:
                c = self._codes.get(key)
                if c is None:
                    c = self._codes[key] = len(self._names)
                    self._names.append((name, attrs))
        return c << 2

    # -- the rings ----------------------------------------------------------------------
    def harvest(self, device: torch.device | None = None) -> None:
        """Read the ring of ``device`` (every ring when None) into spans and
        counts."""
        card = None if device is None or device.type != "cuda" else _card(device)
        for dev, r in list(self._rings.items()):
            if device is None or dev == card:
                self._decode(r, *r.read())

    def _decode(self, r: _Ring, counters: list[int], made: int, body: list[list[int]]) -> None:
        req = self._request()
        for name, v in zip(r.counters, counters):
            if v:
                self._counts.append((name, v, req, time.perf_counter()))
        if made > RING_SLOTS:
            self.count("trace.ring_overflow", made - RING_SLOTS)
        if not body:
            return
        if r.t0_ns is None:
            r.t0_ns = body[0][1]
        clock = str(r.device)
        opened: list[tuple[int, int, int]] = []  # (code id, span id, ns)
        for code, ns in body:
            kind, payload = code & 3, code >> 2
            if kind == _MARK:
                req = payload
            elif kind == _START:
                opened.append((payload, next(self._ids), ns))
            else:  # an end closes the innermost open span of its code
                k = next((k for k in range(len(opened) - 1, -1, -1) if opened[k][0] == payload),
                         None)
                if k is None:  # its start was past the ring's end
                    continue
                _, sid, ns0 = opened[k]
                del opened[k:]
                parent = opened[-1][1] if opened else req
                name, attrs = self._names[payload]
                self._spans.append((sid, name, (ns0 - r.t0_ns) * 1e-9, (ns - r.t0_ns) * 1e-9,
                                    parent, req, clock, attrs))

    # -- the switch ---------------------------------------------------------------------
    def enable(self) -> None:
        if torch.cuda.is_available():
            self.ring(torch.device("cuda", torch.cuda.current_device()))
        self.on = True

    def reset(self) -> None:
        for dev, r in self._rings.items():
            torch.cuda.synchronize(dev)
            r.buf[:_HEAD].zero_()
        self._spans.clear()
        self._counts.clear()

    def snapshot(self) -> dict:
        for dev in self._rings:
            torch.cuda.synchronize(dev)
        self.harvest()
        keys = ("id", "name", "start", "end", "parent", "request", "clock", "attrs")
        spans = sorted(self._spans, key=lambda s: (s[6], s[2]))
        return {"spans": [dict(zip(keys, s)) for s in spans],
                "counts": [dict(zip(("name", "value", "request", "time"), c))
                           for c in self._counts]}


REGISTRY = Registry()


def _profiled() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _HostSpan:
    __slots__ = ("name", "attrs", "record", "rf", "t0", "parent", "frame")

    def __init__(self, name: str, attrs: dict, record: bool):
        self.name, self.attrs, self.record = name, attrs, record
        self.rf = None

    def __enter__(self):
        if _profiled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if self.record:
            self.parent = REGISTRY._parent()
            self.frame = _Frame(next(REGISTRY._ids))
            REGISTRY._stack().append(self.frame)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.record:
            t1 = time.perf_counter()
            s = REGISTRY._stack()
            if s and s[-1] is self.frame:
                s.pop()
            REGISTRY.add_span(self.name, self.t0, t1, self.parent, self.attrs, self.frame.id)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _DeviceSpan:
    __slots__ = ("name", "ring", "code", "rf", "frame")

    def __init__(self, name: str, ring: _Ring | None, code: int):
        self.name, self.ring, self.code = name, ring, code
        self.rf = None

    def __enter__(self):
        if _profiled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if self.ring is not None:
            self.frame = _Frame(None)
            REGISTRY._stack().append(self.frame)
            self.ring.stamp(self.code | _START)
        return self

    def __exit__(self, *exc):
        if self.ring is not None:
            self.ring.stamp(self.code | _END)
            s = REGISTRY._stack()
            if s and s[-1] is self.frame:
                s.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Request:
    __slots__ = ("name", "attrs", "device", "prev", "parent", "frame", "t0")

    def __init__(self, name: str, attrs: dict, device):
        self.name, self.attrs, self.device = name, attrs, device

    def __enter__(self):
        reg = REGISTRY
        self.parent = reg._parent()
        self.frame = _Frame(next(reg._ids))
        self.prev = reg._request()
        reg._local.request = self.frame.id
        reg._stack().append(self.frame)
        if self.device is not None and torch.device(self.device).type == "cuda":
            reg.ring(torch.device(self.device)).stamp(self.frame.id << 2 | _MARK)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        reg = REGISTRY
        t1 = time.perf_counter()
        s = reg._stack()
        if s and s[-1] is self.frame:
            s.pop()
        reg.add_span(self.name, self.t0, t1, self.parent, self.attrs, self.frame.id)
        reg._local.request = self.prev
        return False


def enable() -> None:
    """Turn tracing on: spans and counters are recorded from here, and a
    step captured from here holds stamps (on a card, the stamp kernel is
    built and the card's ring made first)."""
    REGISTRY.enable()


def disable() -> None:
    """Turn tracing off; what was recorded stays until ``reset``."""
    REGISTRY.on = False


def enabled() -> bool:
    return REGISTRY.on


def reset() -> None:
    """Forget what was recorded (on a card, after waiting for it)."""
    REGISTRY.reset()


def snapshot() -> dict:
    """Everything recorded, after the cards have finished and their rings
    been read: {"spans": [{id, name, start, end, parent, request, clock,
    attrs}], "counts": [{name, value, request, time}]}, spans ordered by
    clock and start. ``clock`` is "host" (seconds of ``time.perf_counter``)
    or the card ("cuda:0": seconds of its clock from its first stamp)."""
    return REGISTRY.snapshot()


def span(name: str, **attrs):
    """A host span of ``name`` around the block (module docstring)."""
    if not (REGISTRY.on or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _HostSpan(name, attrs, REGISTRY.on)


def request(name: str, device: str | torch.device | None = None, **attrs):
    """A request's span around the block (registry only, no profiler
    range): every span opened inside it, on this thread, and every device
    span that ``device``'s stream runs after it, carries its id."""
    if not REGISTRY.on:
        return _NULL
    return _Request(name, attrs, device)


def device_span(name: str, device: str | torch.device, numbered: bool = False, **attrs):
    """A span of the work queued on ``device``'s current stream inside the
    block, stamped by the card (module docstring); on the CPU a host span.
    ``numbered`` adds ``index``: how many spans of ``name`` the enclosing
    span opened before this one."""
    reg = REGISTRY
    if not (reg.on or _autograd_profiler._is_profiler_enabled):
        return _NULL
    if numbered and reg.on:
        attrs = reg._numbered(name, attrs)
    dev = torch.device(device)
    if dev.type != "cuda":
        return _HostSpan(name, attrs, reg.on)
    if not reg.on:
        return _DeviceSpan(name, None, 0)
    return _DeviceSpan(name, reg.ring(dev), reg.code(name, attrs))


def count(name: str, value: float) -> None:
    """Record a count of ``name`` (with tracing on)."""
    if REGISTRY.on:
        REGISTRY.count(name, value)


def device_count(name: str, value: torch.Tensor) -> None:
    """Add the 0-d ``value`` to the device counter ``name`` in stream order
    (with tracing on); the host records the sum at the next read of the
    card's ring where it is not 0. On the CPU, a count."""
    if not REGISTRY.on:
        return
    if value.is_cuda:
        REGISTRY.ring(value.device).add(name, value)
    else:
        REGISTRY.count(name, value.item())


def harvest(device: str | torch.device | None = None) -> None:
    """Read ``device``'s ring (every card's when None) into the registry,
    at a point where the card has finished the stream's work: after a
    read-back. A no-op with tracing off or on the CPU."""
    if REGISTRY.on and REGISTRY._rings:
        REGISTRY.harvest(None if device is None else torch.device(device))


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a ``python.gc`` span of each collection."""
    reg = REGISTRY
    if phase == "start":
        if reg.on or _autograd_profiler._is_profiler_enabled:
            rf = None
            if _autograd_profiler._is_profiler_enabled:
                rf = record_function("python.gc")
                rf.__enter__()
            reg._gc = (time.perf_counter(), rf, reg._parent() if reg.on else None,
                       info.get("generation"))
    elif reg._gc is not None:
        t0, rf, parent, generation = reg._gc
        reg._gc = None
        if reg.on:
            reg.add_span("python.gc", t0, time.perf_counter(), parent,
                         {"generation": generation})
        if rf is not None:
            rf.__exit__(None, None, None)


if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)


def self_times(spans: list[dict]) -> dict[int, float]:
    """Each span's self time (seconds): its duration less the part of it
    that its children on the same clock cover."""
    kids: dict[int, list[tuple[float, float]]] = defaultdict(list)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        p = by_id.get(s["parent"])
        if p is not None and p["clock"] == s["clock"]:
            kids[p["id"]].append((max(s["start"], p["start"]), min(s["end"], p["end"])))
    out = {}
    for s in spans:
        covered, reach = 0.0, s["start"]
        for a, b in sorted(kids.get(s["id"], ())):
            a = max(a, reach)
            if b > a:
                covered += b - a
                reach = b
        out[s["id"]] = (s["end"] - s["start"]) - covered
    return out


def timer_steps_ns(device: str | torch.device = "cuda", n: int = 64) -> list[int]:
    """The first ``n`` changes of the card's ``%globaltimer`` seen by one
    thread, in nanoseconds: the smallest is the clock's resolution."""
    from facerec_torch import build

    dev = torch.device(device)
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    fn = build.function("trace_stamp", "trace_timer_steps_launch",
                        (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(dev):
        build.check(fn(out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream),
                    "trace_timer_steps")
    return out.cpu().tolist()


class StageTimer:
    """Accumulate wall time per named stage; waits on the device of the
    stage's result (``result=``, or ``box["result"]`` set inside the
    block) before it stops the clock. Each stage is a ``span``."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        box = {}
        try:
            with span(name):
                try:
                    yield box
                finally:
                    out = box.get("result", result)
                    if out is not None:
                        block_until_ready(out)
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_sec": v, "count": self.counts[k],
                "mean_ms": 1000 * v / max(self.counts[k], 1)}
            for k, v in self.totals.items()
        }


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write ``<log_dir>/trace.json`` (Chrome trace format;
    open in chrome://tracing or Perfetto; default ``outputs/trace``).
    Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.config import OUTPUTS_DIR

    d = Path(log_dir) if log_dir is not None else OUTPUTS_DIR / "trace"
    d.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield d
    prof.export_chrome_trace(str(d / "trace.json"))


def device_ops(prof) -> list:
    """The card's kernels and copies among a finished ``torch.profiler``
    run's ``key_averages()``: its device-typed entries less the ranges
    (every ``record_function``, this module's spans among them) that the
    profiler also lays on the device timeline, which are not device time."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def timed_call(fn: Callable, *args, iters: int = 10, salt_arg: int | None = 0) -> dict[str, float]:
    """Steady-state time of ``fn(*args)``. When ``salt_arg`` is an int, that
    positional argument (a tensor or float) has the call's index added to
    it, so every call computes on distinct inputs. One warm-up call, then
    ``iters`` calls, then a wait on every device the results live on."""
    args = list(args)
    base = args[salt_arg] if salt_arg is not None else None

    def call(i: int):
        if salt_arg is not None:
            args[salt_arg] = base + float(i)
        return fn(*args)

    block_until_ready(call(iters + 1))  # warm-up
    t0 = time.perf_counter()
    outs = [call(i) for i in range(iters)]
    block_until_ready(outs)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_sec": dt, "mean_ms": dt * 1000, "iters": iters}
