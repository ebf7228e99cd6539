"""Per-stage tracing, off by default (counterpart of
tpu_face/utils/profiling.py).

Turn it on with ``enable()`` or ``TPU_FACE_PROFILE=1``; read what it
recorded with ``collect()``.  While it is on:

* ``stage(name)`` is a span: a ``torch.profiler.record_function`` range
  ``tpu_face/<name>`` (on a CUDA card also an NVTX range), and a host
  span kept in memory: its name, start and end on
  ``time.perf_counter_ns``, its parent (the innermost span open on the
  thread) and the call identifier that every span of one outermost span
  shares.  The cascades label ``infer_batch``, their ``__call__``
  (``cascade.call``, ``embed_cascade.call``) and each stage (the JAX
  package's ``jax.named_scope`` labels: detect, nms, mesh_warp, mesh,
  iris_warp, iris, embed_crop, embed); the trackers their branches.
  While ``torch.export`` traces, ``stage`` does nothing.
* A program captured while tracing is on (``programs.ProgramCache`` keys
  it apart from the untraced one) carries device spans: ``stage`` inside
  its capture launches a begin and an end stamp (``csrc/stage_stamp.cu``,
  the card's global timer written into this call's row of a per-device
  ring), which become nodes of the CUDA graph, or of a ``programs.cond``
  IF node's body, so that a branch that did not run yields no span.  The
  program adds ``programs.graph`` (its first node to its last) and
  ``programs.copy_in`` (eager stamps around its input copies), and the
  host spans ``programs.call``, ``programs.copy_in``,
  ``programs.launch`` and ``programs.clone_out``.
* One clock: a stamp launched on an idle stream between two reads of the
  host's clock pairs the device's timer with ``perf_counter_ns``, at the
  start and at the end of a collection; every device span is mapped onto
  the host clock between the two, and the bracket's width (the pairing's
  error) is reported.

Off, ``stage`` is a shared null context and nothing is built: the
stamp library is built and loaded on the first ``enable()`` on a card
(or the first traced capture).  ``counters`` are always on
(``programs.captures``: one add per capture).
"""

import collections
import contextlib
import ctypes
import functools
import itertools
import os
import threading
import time

import torch

_enabled = os.environ.get("TPU_FACE_PROFILE", "0") not in ("", "0")
_NULL = contextlib.nullcontext()

# the stamp ring's shape (csrc/stage_stamp.cu holds the same): rows of
# the last calls, slots a row (two a span), head words before the rows
ROWS = 4096
SLOTS = 512
_HEAD = 2
# brackets tried per clock pairing; the narrowest is kept
PAIR_TRIES = 16
# host spans kept between collections; later ones are counted, not kept
MAX_SPANS = 1 << 20

# the names of the program's own device spans, in their slots
COPY_IN, GRAPH = "programs.copy_in", "programs.graph"

counters = collections.Counter()

_local = threading.local()     # .stack: open host spans; .rec: recorder
_spans = []                    # [name, start ns, end ns, parent, call]
_replays = []                  # (device, seq, call, table) of each call
_devices = {}                  # device index -> _Device
_call_ids = itertools.count(1)
_seqs = itertools.count(1)


def enable(on: bool = True) -> None:
    """Turn tracing on or off for this process (on a card, the first
    ``enable()`` builds the stamp library)."""
    global _enabled
    _enabled = bool(on)
    if _enabled and torch.cuda.is_available():
        prepare(torch.cuda.current_device())


def enabled() -> bool:
    return _enabled


def count(name: str, n: int = 1) -> None:
    counters[name] += n


def stage(name: str):
    """The span ``name`` (a shared null context unless tracing is on)."""
    if not _enabled:
        return _NULL
    return _Span(name)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A host span, with a ``record_function`` range while a profiler
    session runs (a range costs microseconds of host time even when none
    does), an NVTX range on a card, and, inside a traced capture, the
    device stamps of its slot."""

    __slots__ = ("name", "span", "rec", "slot", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        if torch.compiler.is_exporting():
            self.span = None
            return self
        stack = _stack()
        parent = stack[-1] if stack else None
        call = parent[4] if parent is not None else next(_call_ids)
        self.span = [self.name, time.perf_counter_ns(), None, parent, call]
        if len(_spans) < MAX_SPANS:
            _spans.append(self.span)
        else:
            counters["spans.dropped"] += 1
        self.rec = getattr(_local, "rec", None)
        self.slot = (self.rec.open(self.name) if self.rec is not None
                     else None)
        label = f"tpu_face/{self.name}"
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(label)
            self.rf.__enter__()
        if _on_card():
            torch.cuda.nvtx.range_push(label)
        stack.append(self.span)
        return self

    def __exit__(self, *exc):
        if self.span is None:
            return False
        _stack().pop()
        if _on_card():
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.slot is not None:
            self.rec.close(self.slot)
        self.span[2] = time.perf_counter_ns()
        return False


@functools.cache
def _on_card():
    return torch.cuda.is_available()


def _current_call():
    """The call identifier of the innermost open span (None outside
    one)."""
    stack = _stack()
    return stack[-1][4] if stack else None


# ---- device stamps ----------------------------------------------------


class _Device:
    """A card's stamp ring, its idle stream and its clock pairings."""

    def __init__(self, index):
        from ..ops import _build

        self.index = index
        self.launch = _build.launch
        self.open = _build.entry("stage_stamp", "stage_stamp_open")
        self.stamp = _build.entry("stage_stamp", "stage_stamp")
        self.pair_fn = _build.entry("stage_stamp", "stage_stamp_pair")
        with torch.cuda.device(index):
            self.ring = torch.zeros(_HEAD + ROWS * (1 + SLOTS),
                                    dtype=torch.int64, device="cuda")
            self.idle = torch.cuda.Stream(index)
        self.ptr = self.ring.data_ptr()
        self.pairs = []

    def mark(self, slot):
        """A stamp into ``slot`` of the current row, on the current
        stream (a node of the graph under a capture)."""
        self.launch(self.stamp, self.index, self.ptr, slot)

    def pair(self):
        """(host ns, device ns, bracket ns): the narrowest of
        ``PAIR_TRIES`` stamps on the idle stream, each between two reads
        of the host's clock."""
        out = (ctypes.c_int64 * 3)()
        best = None
        for _ in range(PAIR_TRIES):
            err = self.pair_fn(self.ptr + 8, out, self.idle.cuda_stream)
            if err != 0:
                raise RuntimeError(f"stage_stamp_pair: CUDA error {err}")
            width = out[1] - out[0]
            if best is None or width < best[2]:
                best = ((out[0] + out[1]) // 2, out[2], width)
        return best


def prepare(index):
    """The card ``index``'s stamp state, made (the library built and
    loaded, the ring allocated, the collection's first pairing taken) on
    first use: before a capture, never inside one."""
    dev = _devices.get(index)
    if dev is None:
        dev = _devices[index] = _Device(index)
        dev.pairs.append(dev.pair())
    return dev


class _Recorder:
    """The span table of a program captured on card ``index``: slots
    0-1 ``programs.copy_in``, 2-3 ``programs.graph``, then each span
    ``stage`` opens inside the capture, in order, with its parent's
    entry; ``stage`` captures its stamps."""

    def __init__(self, index):
        self.dev = _devices[index]
        self.table = [(COPY_IN, None), (GRAPH, None)]
        self.open_ = [1]

    def open(self, name):
        j = len(self.table)
        if 2 * j + 2 > SLOTS:
            counters["spans.unslotted"] += 1
            return None
        self.table.append((name, self.open_[-1]))
        self.open_.append(j)
        self.dev.mark(2 * j)
        return j

    def close(self, j):
        self.open_.pop()
        self.dev.mark(2 * j + 1)


@contextlib.contextmanager
def graph_spans(index):
    """Inside a capture on card ``index`` (``prepare``d before it): the
    block between the ``programs.graph`` stamps, with the spans that
    ``stage`` opens in it stamped; yields the span table
    (``_Recorder.table``)."""
    rec = _Recorder(index)
    dev = rec.dev
    dev.mark(2)
    saved = getattr(_local, "rec", None)
    _local.rec = rec
    try:
        yield rec.table
    finally:
        _local.rec = saved
    dev.mark(3)


def open_copy_in(index, table):
    """A traced program's call on card ``index``: its row of the ring
    taken by the begin stamp of ``programs.copy_in`` (launched on the
    current stream), its spans to be read from ``table``."""
    dev = _devices[index]
    seq = next(_seqs)
    _replays.append((index, seq, _current_call(), table))
    dev.launch(dev.open, index, dev.ptr, seq, 0)


def close_copy_in(index):
    _devices[index].mark(1)


# ---- the collection ---------------------------------------------------


def _clock(pairs):
    """(device ns -> host ns, drift in ppm: host ns per device ns, less
    one) from the collection's pairings: the offset at the first, the
    rate between the first and the last."""
    h0, d0, _ = pairs[0]
    h1, d1, _ = pairs[-1]
    rate = (h1 - h0) / (d1 - d0) if d1 > d0 else 1.0
    drift = (rate - 1.0) * 1e6
    return (lambda d: h0 + round((d - d0) * rate)), drift


def decode(rings, replays, clocks):
    """Device spans from the rings' rows: ``rings`` {device: int64
    numpy ring}, ``replays`` [(device, seq, call, table)], ``clocks``
    {device: device ns -> host ns}.  Returns (spans, calls lost): each span
    [name, start, end, parent (an index into the list or None), call,
    seq]; a table entry whose two slots are not both set (a branch that
    did not run) yields none; a row that a later call took is lost."""
    out, lost = [], 0
    for index, seq, call, table in replays:
        ring = rings[index]
        base = _HEAD + (seq % ROWS) * (1 + SLOTS)
        if ring[base] != seq:
            lost += 1
            continue
        slots = ring[base + 1:base + 1 + SLOTS]
        to_host = clocks[index]
        where = {}
        for j, (name, parent) in enumerate(table):
            begin, end = int(slots[2 * j]), int(slots[2 * j + 1])
            if begin and end:
                where[j] = len(out)
                out.append([name, to_host(begin), to_host(end),
                            where.get(parent), call, seq])
    return out, lost


def self_times(spans):
    """Each span's duration less the union of its children's, clipped
    to it: ``spans`` [name, start, end, parent index, ...]."""
    kids = collections.defaultdict(list)
    for i, s in enumerate(spans):
        if s[3] is not None:
            kids[s[3]].append((s[1], s[2]))
    out = []
    for i, s in enumerate(spans):
        covered, reach = 0, s[1]
        for a, b in sorted(kids.get(i, ())):
            a, b = max(a, reach), min(b, s[2])
            if b > a:
                covered += b - a
                reach = b
        out.append(s[2] - s[1] - covered)
    return out


def collect():
    """What was recorded since the last ``collect()`` or ``reset()``,
    then cleared: {"spans": [{"name", "kind" ("host" or "device"),
    "start_ns", "end_ns", "self_ns", "parent" (an index into the list, a
    span of the same kind, or None), "call", "seq" (the traced program
    call of a device span)}], "counters": {name: n}, "clock": {device:
    {"error_ns" (the widest pairing bracket), "drift_ppm", "pairs"}},
    "lost_calls"}.  Host and device times are on ``perf_counter_ns``.
    Spans still open are left out."""
    rings, clocks, clock = {}, {}, {}
    for index, dev in _devices.items():
        torch.cuda.synchronize(index)
        dev.pairs.append(dev.pair())
        rings[index] = dev.ring.cpu().numpy()
        clocks[index], drift = _clock(dev.pairs)
        clock[index] = {"error_ns": max(p[2] for p in dev.pairs),
                        "drift_ppm": drift, "pairs": len(dev.pairs)}
    done = [s for s in _spans if s[2] is not None]
    index = {id(s): i for i, s in enumerate(done)}
    spans = [[s[0], s[1], s[2], index.get(id(s[3])), s[4], None]
             for s in done]
    device, lost = decode(rings, _replays, clocks)
    kinds = ["host"] * len(spans) + ["device"] * len(device)
    spans += [[n, a, b, None if p is None else p + len(done), c, q]
              for n, a, b, p, c, q in device]
    got = {"spans": [
        {"name": n, "kind": k, "start_ns": a, "end_ns": b, "self_ns": own,
         "parent": p, "call": c, "seq": q}
        for (n, a, b, p, c, q), k, own in zip(spans, kinds,
                                              self_times(spans))],
        "counters": dict(counters), "clock": clock, "lost_calls": lost}
    reset()
    return got


def reset():
    """Clear the spans and counters; on each card with a ring, the next
    collection's first clock pairing."""
    _spans.clear()
    _replays.clear()
    counters.clear()
    for index, dev in _devices.items():
        torch.cuda.synchronize(index)
        dev.pairs = [dev.pair()]
