"""Per-geometry CUDA-graph programs: the counterpart of the JAX package's
``_get_jitted`` caches.

JAX builds one program per geometry on the first call (``jax.jit`` and
its shape-keyed retrace) and dispatches it once on every later call.
Here the first call at a key captures the device function as a CUDA
graph, and every later call copies its inputs into the graph's static
buffers, replays it (one queue entry in place of the ~550 to ~1,500
kernel launches of the eager call) and returns fresh copies of its
outputs, so that a result the caller holds does not change on the next
call.

A key is a name (the program and whatever static arguments select it)
and the shape and type of every input, and while tracing is on
(``utils.profiling``) a trailing ``STAMPED``: the program captured then
carries the device stamps of its spans, beside the untraced one, and
its calls record host spans (``Program.stamped_call``).  The cache is
unbounded, like ``_jitted``; each graph has its own memory pool.  On a
CPU device the function runs eagerly and no entry is made.  A capture or
replay error raises: nothing falls back to the eager call.  The eager
path stays callable as the objects' ``_forward`` (or their
``device="cpu"``).

``cond`` is the counterpart of ``lax.cond`` and the one place where the
package takes a branch on device data: inside a capture both branches
become CUDA-graph conditional (IF) nodes, so a replay runs the branch
its predicate picks without a read to the host; while ``torch.export``
traces, it becomes a ``torch.cond`` node of the exported program.
"""

import collections
import contextlib
import functools
import threading
import time
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from . import exact_f32
from .ops import _build
from .utils import profiling

# eager calls on a side stream before the capture (lazy caches, cuBLAS
# and cuDNN handles and workspaces are made outside the graph), each with
# both sides of every ``cond`` run
WARMUPS = 2

# the last part of a traced program's key
STAMPED = "stamped"

# this thread's branch mode: ``specs`` is the list ``both_branches``
# records into, ``capture`` the queue of output specs a capture's conds
# allocate from
_BRANCH = threading.local()


@contextlib.contextmanager
def both_branches():
    """Inside the block every ``cond`` runs both of its branches and picks
    each output with ``torch.where``: no read of its predicate, and every
    lazy cache, handle and workspace of either side made.  Yields the
    list of each cond's output spec (tree and leaf shapes, types and
    devices), in the order the conds were entered; a capture's conds
    allocate their outputs from it."""
    saved = getattr(_BRANCH, "specs", None)
    _BRANCH.specs = []
    try:
        yield _BRANCH.specs
    finally:
        _BRANCH.specs = saved


@contextlib.contextmanager
def _capturing(specs):
    """The block captures a CUDA graph whose conds were entered, in this
    order, by the both-branch run that recorded ``specs``."""
    saved = (getattr(_BRANCH, "capture", None),
             getattr(_BRANCH, "pools", None), getattr(_BRANCH, "depth", 0))
    _BRANCH.capture = collections.deque(specs)
    # the IF-node bodies' pools by nesting depth, [pool, bodies captured
    # into it] each, and the depth of the body being captured
    _BRANCH.pools, _BRANCH.depth = [], 0
    try:
        yield _BRANCH.pools
        if _BRANCH.capture:
            raise RuntimeError(f"{len(_BRANCH.capture)} cond(s) of the "
                               f"warm-up were not reached in the capture")
    finally:
        _BRANCH.capture, _BRANCH.pools, _BRANCH.depth = saved


def _release_pools(device, pools):
    """Give back the bodies' pools: the allocator counts one use of a pool
    per body captured into it."""
    for pool, uses in pools:
        for _ in range(uses):
            torch._C._cuda_releasePool(device, pool)


def _spec(out):
    leaves, tree = pytree.tree_flatten(out)
    return tree, [(t.shape, t.dtype, t.device) for t in leaves]


def _check_same(spec, other, where):
    if spec != other:
        raise ValueError(f"cond: the branches' outputs differ ({where}): "
                         f"{spec} against {other}")


def cond(pred, true_fn, false_fn, operands=()):
    """``true_fn(*operands)`` where the bool scalar tensor ``pred`` holds,
    else ``false_fn(*operands)`` (``jax.lax.cond``).  Both branches return
    the same tree of tensors with the same shapes and types, else
    ``ValueError``.  Four modes:

    * while ``torch.export`` traces, a ``torch.cond`` node
      (``_exported``);
    * under a CUDA-graph capture (``Program``), each branch is captured
      into an IF node, on ``pred`` and on its negation; each writes its
      outputs into buffers allocated before both, so neither body can
      overwrite an operand or the other's result.  A replay runs one
      body and reads nothing back to the host.  Conds nest;
    * inside ``both_branches``, both run and ``torch.where`` picks;
    * otherwise (the CPU, an eager call on the card) the branch is taken
      by reading ``pred``."""
    if torch.compiler.is_exporting():
        return _exported(pred, true_fn, false_fn, operands)
    specs = getattr(_BRANCH, "specs", None)
    if specs is not None:
        slot = len(specs)
        specs.append(None)
        a = true_fn(*operands)
        b = false_fn(*operands)
        specs[slot] = _spec(a)
        _check_same(specs[slot], _spec(b), "both branches run")
        leaves, tree = pytree.tree_flatten(a)
        return pytree.tree_unflatten(
            [torch.where(pred, x, y)
             for x, y in zip(leaves, pytree.tree_leaves(b))], tree)
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        return _if_nodes(pred, true_fn, false_fn, operands)
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


class _FreeTensors(TorchFunctionMode):
    """Inside the block, the tensors that torch functions read and that
    are neither in ``known`` (a branch's operands) nor made in the block:
    the weights, cached constants and outer results a branch closes over.
    ``found`` collects them by identity; with ``lifted`` ({id: tensor})
    each is replaced by its tensor instead, and an unlisted one raises."""

    def __init__(self, known, lifted=None):
        super().__init__()
        self.known = {id(t) for t in known}
        # every tensor of ``known`` and made here, so no id is reused
        self.held = list(known)
        self.found = {}
        self.lifted = lifted

    def _read(self, t, func):
        if id(t) in self.known:
            return t
        if self.lifted is None:
            self.found.setdefault(id(t), t)
            return t
        if id(t) not in self.lifted:
            # e.g. a lazy cache filled by the first run: fill it before
            # the export
            raise RuntimeError(
                f"cond: under export, a branch's {func} read a "
                f"{t.dtype} {tuple(t.shape)} tensor that its first run "
                f"did not read")
        return self.lifted[id(t)]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map_only(
            torch.Tensor, lambda t: self._read(t, func),
            (args, kwargs or {}))
        out = func(*args, **kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.known.add(id(t))
                self.held.append(t)
        return out


def _exported(pred, true_fn, false_fn, operands):
    """``cond`` while ``torch.export`` traces: one ``torch.cond`` node
    (the higher-order operator itself, whose branches ``make_fx``
    traces, not ``torch.cond``'s Dynamo front end).  The operands go in
    as a flat tuple and each branch rebuilds their tree.  A branch's
    graph may read no tensor it does not take, so a first run of each
    branch, not traced, finds the tensors it closes over (the nets'
    weights, cached constants, outer results): they go in after the
    operands, and inside the traced branches each read of one reads its
    input instead.  Every output is a clone: ``torch.cond`` refuses a
    branch whose output aliases an input or another output, and a
    branch may return an operand (an identity branch) or a view of one
    (the tracked stages pass their ``valid`` through)."""
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    leaves, tree = pytree.tree_flatten(operands)
    found, specs = {}, []
    with disable_proxy_modes_tracing():
        for fn in (true_fn, false_fn):
            with _FreeTensors(leaves) as mode:
                specs.append(_spec(fn(*pytree.tree_unflatten(leaves, tree))))
            found.update(mode.found)
    _check_same(specs[0], specs[1], "exported")
    free = list(found.values())
    n = len(leaves)

    def traced(fn):
        def branch(*flat):
            mine = list(flat[:n])
            lifted = {id(a): b for a, b in zip(free, flat[n:])}
            with _FreeTensors(mine, lifted):
                out = pytree.tree_leaves(fn(*pytree.tree_unflatten(mine,
                                                                   tree)))
            return tuple(t.clone() for t in out)
        return branch

    out = torch.ops.higher_order.cond(pred, traced(true_fn),
                                      traced(false_fn), (*leaves, *free))
    return pytree.tree_unflatten(list(out), specs[0][0])


def _if_nodes(pred, true_fn, false_fn, operands):
    """``cond`` under a capture: the output buffers from the warm-up's
    spec, then one IF node per branch (``csrc/graph_cond.cu``), its body
    captured from ``_body_stream`` with the body's allocations in a pool
    of the capture's own for its nesting depth."""
    queue = getattr(_BRANCH, "capture", None)
    if not queue:
        raise RuntimeError("cond under a CUDA-graph capture needs the "
                           "output specs of a both_branches warm-up")
    tree, metas = queue.popleft()
    outs = [torch.empty(shape, dtype=dtype, device=device)
            for shape, dtype, device in metas]
    index = pred.get_device()
    depth = _BRANCH.depth
    body = _body_stream(pred.device, depth)
    if depth == len(_BRANCH.pools):
        _BRANCH.pools.append([torch.cuda.graph_pool_handle(), 0])
    pool = _BRANCH.pools[depth]
    begin = _build.entry("graph_cond", "graph_if_begin")
    end = _build.entry("graph_cond", "graph_if_end")
    for negate, fn in ((0, true_fn), (1, false_fn)):
        _build.launch(begin, index, pred.data_ptr(), negate,
                      body.cuda_stream)
        _BRANCH.depth += 1
        try:
            with torch.cuda.stream(body):
                _allocate_to_pool(index, pool[0])
                pool[1] += 1
                got = fn(*operands)
                _check_same((tree, metas), _spec(got), "captured")
                for buf, t in zip(outs, pytree.tree_leaves(got)):
                    buf.copy_(t)
                del got
        finally:
            _BRANCH.depth -= 1
            torch._C._cuda_endAllocateToPool(index, pool[0])
            err = end(body.cuda_stream)
        if err != 0:
            raise RuntimeError(f"graph_if_end: CUDA error {err}")
    return pytree.tree_unflatten(outs, tree)


@functools.lru_cache(maxsize=None)
def _body_stream(device, depth):
    """The stream IF-node bodies at nesting ``depth`` are captured from
    (one per device and depth, as torch keeps one capture stream)."""
    return torch.cuda.Stream(device)


def _allocate_to_pool(device, pool):
    """The caching allocator's allocations on the body stream go to
    ``pool`` until ``_cuda_endAllocateToPool``: only the capture's own
    allocations are matched by torch's filter, and a body is captured
    from another stream."""
    if hasattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool"):
        torch._C._cuda_beginAllocateCurrentStreamToPool(device, pool)
    else:
        torch._C._cuda_beginAllocateToPool(device, pool)


class Program:
    """One device function captured at one set of input shapes and
    types on ``device``: ``__call__`` copies its inputs in, replays and
    returns fresh outputs.  ``capture_s`` is the seconds the warm-up
    calls and the capture took, ``nbytes`` the bytes of the graph's
    memory pool (its intermediates and static outputs).  A ``stamped``
    program's capture records its spans' device stamps (``table``, the
    span table ``utils.profiling`` reads its rows by) for
    ``stamped_call``."""

    def __init__(self, fn, inputs, device, stamped=False):
        self.device = device
        self.stamped = stamped
        self.table = None
        self._done = None
        t0 = time.perf_counter()
        with torch.inference_mode(), exact_f32():
            self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=device)
                           for x in inputs]
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
            out, self.nbytes = self._capture(fn)
        self.outputs, self._spec = pytree.tree_flatten(out)
        self.capture_s = time.perf_counter() - t0

    def _capture(self, fn):
        """Warm up on a side stream, then capture one call of ``fn`` on
        the static inputs; returns (its static outputs, pool bytes)."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUPS):
                    with both_branches() as specs:
                        fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            index = self.index = torch.cuda.current_device()
            if self.stamped:
                profiling.prepare(index)
            before = torch.cuda.memory_reserved()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph), _capturing(specs) as pools:
                if self.stamped:
                    with profiling.graph_spans(index) as self.table:
                        out = fn(*self.inputs)
                else:
                    out = fn(*self.inputs)
            weakref.finalize(self, _release_pools, index,
                             [tuple(p) for p in pools])
            torch.cuda.synchronize()
            return out, torch.cuda.memory_reserved() - before

    def replay(self):
        """One replay on the current stream (the outputs stay in the
        graph's static buffers)."""
        self.graph.replay()

    @contextlib.contextmanager
    def _serialized(self):
        """The block after the last call's, whichever stream made it: the
        static buffers are free once its copies are done."""
        stream = torch.cuda.current_stream(self.device)
        if self._done is not None:
            stream.wait_event(self._done)
        yield
        self._done = stream.record_event()

    def __call__(self, *inputs):
        with torch.inference_mode(), self._serialized():
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
            self.replay()
            out = [t.clone() for t in self.outputs]
        return pytree.tree_unflatten(out, self._spec)

    def stamped_call(self, *inputs):
        """``__call__`` in the spans ``programs.call``, ``programs.copy_in``
        (also on the device, by eager stamps that take this call's row of
        the ring), ``programs.launch`` and ``programs.clone_out``."""
        index = self.index if self.table else None
        with (torch.inference_mode(), self._serialized(),
              profiling.stage("programs.call")):
            with profiling.stage(profiling.COPY_IN):
                if index is not None:
                    profiling.open_copy_in(index, self.table)
                for buf, x in zip(self.inputs, inputs):
                    buf.copy_(x)
                if index is not None:
                    profiling.close_copy_in(index)
            with profiling.stage("programs.launch"):
                self.replay()
            with profiling.stage("programs.clone_out"):
                out = [t.clone() for t in self.outputs]
        return pytree.tree_unflatten(out, self._spec)


class ProgramCache:
    """{key: Program} of one object on its device (a replica on another
    card has its own)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.entries = {}

    def __call__(self, name, fn, *inputs):
        """``fn(*inputs)``: on the card through the program cached for
        ``name`` and the inputs' shapes and types (captured on first
        use), on the CPU eagerly."""
        if not self.on_card:
            return fn(*inputs)
        key = (name,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
        if profiling.enabled():
            return self._program(key + (STAMPED,), fn, inputs,
                                 True).stamped_call(*inputs)
        return self._program(key, fn, inputs, False)(*inputs)

    def _program(self, key, fn, inputs, stamped):
        program = self.entries.get(key)
        if program is None:
            program = self.entries[key] = Program(fn, inputs, self.device,
                                                  stamped)
            profiling.count("programs.captures")
        return program
