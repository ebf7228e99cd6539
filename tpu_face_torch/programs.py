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
and the shape and type of every input.  The cache is unbounded, like
``_jitted``; each graph has its own memory pool.  On a CPU device the
function runs eagerly and no entry is made.  A capture or replay error
raises: nothing falls back to the eager call.  The eager path stays
callable as the objects' ``_forward`` (or their ``device="cpu"``).
"""

import contextlib
import time

import torch
from torch.utils import _pytree as pytree

from . import exact_f32

# eager calls on a side stream before the capture (lazy caches, cuBLAS
# and cuDNN handles and workspaces are made outside the graph)
WARMUPS = 2


class Program:
    """One device function captured at one set of input shapes and
    types on ``device``: ``__call__`` copies its inputs in, replays and
    returns fresh outputs.  ``capture_s`` is the seconds the warm-up
    calls and the capture took, ``nbytes`` the bytes of the graph's
    memory pool (its intermediates and static outputs)."""

    def __init__(self, fn, inputs, device):
        self.device = device
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
                    fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                out = fn(*self.inputs)
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
        program = self.entries.get(key)
        if program is None:
            program = self.entries[key] = Program(fn, inputs, self.device)
        return program(*inputs)
