"""Ahead-of-time programs: a cascade's or a tracker's batched program as
a ``torch.export`` artifact (counterpart of tpu_face/aot.py).

``save()`` traces ``obj``'s program at one (batch, height, width) with
``torch.export`` and writes it, the weights as constants, into one file;
``load()`` reads it back into a ``LoadedProgram``; ``attach()`` installs
the loaded programs into a live cascade or tracker, so that the ordinary
host API (``__call__`` / ``infer_batch`` / ``step``) runs them instead of
its Python stages.  The kernels are registered operators
(``torch.ops.tpu_face_torch.*``), so a program exported on the card
launches the same kernels as the live cascade, one operator node per
warp launch and per fused residual run.

A cascade's artifact holds one program, its ``_forward``.  The port's
tracker step takes its two branches on the host (``tracking.py``), so a
tracker's artifact holds the programs those branches call: the full
cascade at the step's batch B ("full") and at the repair batch ("repair",
where it differs from B), and the tracked stages at B ("tracked").

Kinds:

- ``"export"`` (the default): the ``torch.export`` program, the
  counterpart of the JAX package's ``"stablehlo"``.  It is not
  StableHLO, so it does not take that name.
- ``"executable"`` raises ``ValueError`` in ``save``, the JAX module's
  contract for a backend without it: a compiled AOTInductor package
  cannot call kernels that Python launches through ``ctypes``.  It waits
  until the kernels are bound as C++ operators.

The container is pickle-free and safe to load from untrusted sources:
a magic prefix, a u64-be length, a JSON header (the metadata, which
program is which, and a table of tensors), then the payload: each
program's graph as ``torch.export``'s JSON and each tensor's raw bytes,
stored once however many programs read it.  ``load`` never unpickles:
it hands the deserializer tensors it built from those bytes, never
serialized state for ``torch.load`` to read.

An artifact is tied to its device type ("cuda" or "cpu"), its frame
geometry and its batch, as an XLA program is; ``pad_batch`` lets smaller
cascade batches ride it.
"""

import json
import struct
from pathlib import Path

import numpy as np
import torch

from . import exact_f32
# (importing the pipeline registers the kernels' operators, which the
# programs call)
from .pipeline import CascadeResult, EmbedCascade, EmbedResult, _DetectorBase
from .tracking import TrackerPrograms, _TrackerBase

_FORMAT = "tpu-face-torch-aot-v1"
# pickle-free container: magic, u64-be header length, JSON header, payload
_MAGIC = b"TPUFACE-TORCH-AOT\x00"
KINDS = ("export", "executable")
_META_KEYS = {"cls", "batch", "height", "width", "layout", "device",
              "max_faces", "programs", "tensors"}
_RESULTS = {cls.__name__: cls for cls in (CascadeResult, EmbedResult)}
_DTYPES = {str(t): t for t in (torch.float32, torch.bfloat16, torch.float16,
                               torch.float64, torch.uint8, torch.int8,
                               torch.int16, torch.int32, torch.int64,
                               torch.bool)}


def _cascade(obj):
    """The cascade of a tracker, or the cascade itself."""
    return obj.cascade if isinstance(obj, _TrackerBase) else obj


def _image_shape(layout, batch, h, w):
    return [batch, 3, h, w] if layout == "planar" else [batch, h, w, 3]


def _modules(obj, batch, h, w):
    """{program name: (module to trace, example inputs)} of ``obj`` at
    ``batch`` frames of h x w."""
    if isinstance(obj, _DetectorBase):
        images = torch.zeros(_image_shape(obj._layout, batch, h, w),
                             dtype=torch.uint8, device=obj.device)
        return {"forward": (obj.export_module((w, h)), (images,))}
    if isinstance(obj, _TrackerBase):
        return obj.export_modules((w, h), batch)
    raise TypeError(f"cannot export {type(obj).__name__}; expected a "
                    "FaceCascade/EmbedCascade, FaceTracker or "
                    "MultiFaceTracker")


def _export(module, args):
    """``torch.export`` of ``module`` on ``args``: non-strict, under
    ``no_grad`` (not ``inference_mode``) and full f32."""
    with torch.no_grad(), exact_f32():
        return torch.export.export(module, args, strict=False)


class _Tensors:
    """The payload's tensor table: each tensor's raw bytes once, keyed by
    its storage and view, in the header as dtype, shape, stride and the
    byte range of the storage span it views.  The table holds every
    tensor it was given, so no storage address in its keys is freed and
    reused by another tensor while it is filled (``save`` drops each
    exported program before it exports the next)."""

    def __init__(self):
        self.rows, self.blobs, self._index, self.size = [], [], {}, 0
        self._held = []

    def add(self, t) -> int:
        t = t.detach()
        key = (t.untyped_storage().data_ptr(), t.storage_offset(), t.dtype,
               tuple(t.shape), t.stride())
        if key not in self._index:
            span = (1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
                    if t.numel() else 0)
            flat = t.as_strided((span,), (1,)).contiguous().cpu()
            blob = flat.view(torch.uint8).numpy().tobytes()
            self.rows.append({"dtype": str(t.dtype), "shape": list(t.shape),
                              "stride": list(t.stride()), "span": span,
                              "offset": self.size, "bytes": len(blob)})
            self.blobs.append(blob)
            self.size += len(blob)
            self._index[key] = len(self.rows) - 1
            self._held.append(t)
        return self._index[key]


def save(obj, path, batch: int, height: int, width: int,
         kind: str = "export") -> Path:
    """Export ``obj``'s batched programs at the given geometry into
    ``path``.

    ``obj``: a ``FaceCascade`` or ``EmbedCascade``, a ``FaceTracker`` or
    a ``MultiFaceTracker``.  The batch size and frame geometry are baked
    into the artifact; save one artifact per serving configuration.  The
    programs run on the device type ``obj`` runs on."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "executable":
        raise ValueError(
            'kind="executable" is not supported by this backend: a compiled '
            "AOTInductor package cannot call the port's kernels, which "
            "Python launches through ctypes; use kind=\"export\"")
    from torch._export.serde import serialize as serde

    path = Path(path)
    tensors = _Tensors()
    graphs, programs = [], []
    for name, (module, args) in _modules(obj, batch, height, width).items():
        ep = _export(module, args)
        for fqn, value in (*ep.state_dict.items(), *ep.constants.items()):
            if not isinstance(value, torch.Tensor):
                raise ValueError(f"{name}: constant {fqn} is a "
                                 f"{type(value).__name__}, not a tensor")
        # the graph's JSON only: the weights go into the tensor table
        graphs.append(serde.serialize(ep).exported_program)
        programs.append({
            "name": name, "batch": int(args[0].shape[0]),
            "inputs": [[str(a.dtype), list(a.shape)] for a in args],
            "result": ("EmbedResult" if isinstance(obj, EmbedCascade)
                       else "CascadeResult"),
            "graph_bytes": len(graphs[-1]),
            "state_dict": {k: tensors.add(v)
                           for k, v in ep.state_dict.items()},
            "params": [k for k, v in ep.state_dict.items()
                       if isinstance(v, torch.nn.Parameter)],
            "constants": {k: tensors.add(v)
                          for k, v in ep.constants.items()}})
    meta = {
        "format": _FORMAT, "kind": kind, "cls": type(obj).__name__,
        "batch": batch, "height": height, "width": width,
        "layout": _cascade(obj)._layout, "device": obj.device.type,
        "max_faces": _cascade(obj).max_faces,
        "torch": torch.__version__, "programs": programs,
        "tensors": tensors.rows}
    if isinstance(obj, _TrackerBase):
        meta["repair_batch"] = obj._repair_n(batch)
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">Q", len(head)))
        f.write(head)
        for graph in graphs:
            f.write(graph)
        for blob in tensors.blobs:
            f.write(blob)
    return path


class _Program:
    """One loaded program: ``__call__(*tensors)`` checks its inputs
    against the saved ones and returns the result NamedTuple."""

    def __init__(self, name, ep, inputs, result):
        self.name = name
        self.module = ep.module()
        self.inputs = inputs
        self.result = result

    def __call__(self, *args):
        got = [[str(a.dtype), list(a.shape)] for a in args]
        if got != self.inputs:
            raise ValueError(f"the artifact's {self.name} program takes "
                             f"{self.inputs} (dtype, shape); got {got}")
        with torch.inference_mode(), exact_f32():
            return self.result(*self.module(*args))


class LoadedProgram:
    """A deserialized artifact: ``meta`` (the JSON header) and
    ``programs`` {name: callable}.  Calling it runs the first program
    (a cascade's ``forward``, a tracker's ``full``) on exactly the
    tensors it was saved with."""

    def __init__(self, meta, programs):
        self.meta = meta
        self.programs = programs

    def __call__(self, *args):
        return self.programs[self.meta["programs"][0]["name"]](*args)


def _not_artifact(path, why):
    return ValueError(f"not a {_FORMAT} artifact: {path} ({why})")


def _tensor(row, payload, device):
    """A tensor from its header row and the payload's bytes."""
    dtype = _DTYPES[row["dtype"]]
    shape, stride = [int(v) for v in row["shape"]], \
        [int(v) for v in row["stride"]]
    span, start, n = int(row["span"]), int(row["offset"]), int(row["bytes"])
    if (len(shape) != len(stride) or min(shape + stride + [0]) < 0
            or start < 0 or start + n > len(payload)
            or n != span * dtype.itemsize
            or span != (1 + sum((a - 1) * s for a, s in zip(shape, stride))
                        if all(shape) else 0)):
        raise ValueError(f"bad tensor row {row}")
    flat = torch.from_numpy(np.frombuffer(payload, np.uint8, n, start).copy())
    return flat.view(dtype).to(device).as_strided(shape, stride)


def _read(path):
    """(meta, payload) of the artifact at ``path``; anything else raises
    ``ValueError``."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise _not_artifact(path, "no magic")
        raw = f.read(8)
        if len(raw) != 8:
            raise _not_artifact(path, "truncated")
        (n,) = struct.unpack(">Q", raw)
        try:
            meta = json.loads(f.read(n).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _not_artifact(path, "bad header") from e
        payload = memoryview(f.read())
    if not isinstance(meta, dict) or meta.get("format") != _FORMAT \
            or meta.get("kind") != "export" or not _META_KEYS <= set(meta):
        raise _not_artifact(path, "bad format")
    return meta, payload


def _programs(path, meta, payload, device):
    """{name: _Program} of an artifact read by ``_read``, its tensors on
    ``device``."""
    from torch._export.serde import serialize as serde

    try:
        # the graphs come first, then the tensors' bytes
        first = sum(int(prog["graph_bytes"]) for prog in meta["programs"])
        tensors = [_tensor(row, payload[first:], device)
                   for row in meta["tensors"]]
        programs, start = {}, 0
        for prog in meta["programs"]:
            end = start + int(prog["graph_bytes"])
            graph = bytes(payload[start:end])
            start = end
            params = set(prog["params"])
            state = {k: (torch.nn.Parameter(tensors[i], requires_grad=False)
                         if k in params else tensors[i])
                     for k, i in prog["state_dict"].items()}
            consts = {k: tensors[i] for k, i in prog["constants"].items()}
            ep = serde.deserialize(serde.SerializedArtifact(
                graph, state, consts, b""))
            programs[prog["name"]] = _Program(
                prog["name"], ep, prog["inputs"], _RESULTS[prog["result"]])
    except Exception as e:   # untrusted input: any failure is a bad file
        raise _not_artifact(path, f"{type(e).__name__}: {e}") from e
    return programs


def load(path) -> LoadedProgram:
    """Read an artifact written by ``save``, its tensors on the device
    type it was saved on.  Anything else, pickles included, raises
    ``ValueError``; nothing is unpickled."""
    path = Path(path)
    meta, payload = _read(path)
    return LoadedProgram(meta, _programs(path, meta, payload,
                                         torch.device(meta["device"])))


def attach(obj, path, pad_batch: bool = False) -> LoadedProgram:
    """Load an artifact and install its programs as ``obj``'s for the
    saved geometry, so the normal host API runs them (no Python stages).

    The artifact must come from the same class, input layout, device
    type and ``max_faces`` (a tracker's also from the same repair batch).
    A call at another batch then raises ``ValueError`` naming the saved
    batch.  ``pad_batch=True`` (cascades only: trackers carry per-stream
    state, where padding would corrupt the lock bookkeeping) lets
    smaller batches ride the fixed-batch program: frames are zero-padded
    up to the saved batch and the result sliced back; a larger batch
    raises ("exceeds")."""
    if not isinstance(obj, (_DetectorBase, _TrackerBase)):
        raise TypeError(f"cannot attach to {type(obj).__name__}; expected "
                        "a FaceCascade/EmbedCascade, FaceTracker or "
                        "MultiFaceTracker")
    if pad_batch and isinstance(obj, _TrackerBase):
        raise ValueError("pad_batch only applies to stateless cascades; "
                         "tracker steps carry per-stream state")
    path = Path(path)
    meta, payload = _read(path)
    cls = type(obj).__name__
    if meta["cls"] != cls:
        raise ValueError(f"artifact was saved from {meta['cls']}, not {cls}")
    if meta["layout"] != _cascade(obj)._layout:
        raise ValueError(f"artifact layout {meta['layout']!r} != "
                         f"pipeline layout {_cascade(obj)._layout!r}")
    if meta["device"] != obj.device.type:
        raise ValueError(f"artifact device type {meta['device']!r} != "
                         f"pipeline device type {obj.device.type!r}")
    max_faces = _cascade(obj).max_faces
    if meta["max_faces"] != max_faces:
        raise ValueError(f"artifact max_faces {meta['max_faces']} != "
                         f"pipeline max_faces {max_faces}")
    hw, saved = (meta["height"], meta["width"]), meta["batch"]
    if isinstance(obj, _TrackerBase) and \
            meta["repair_batch"] != obj._repair_n(saved):
        raise ValueError(f"artifact repair batch {meta['repair_batch']} != "
                         f"tracker repair batch {obj._repair_n(saved)}")
    prog = LoadedProgram(meta, _programs(path, meta, payload, obj.device))
    if isinstance(obj, _TrackerBase):
        full = prog.programs["full"]
        obj._programs[hw] = TrackerPrograms(
            saved, {saved: full, meta["repair_batch"]:
                    prog.programs.get("repair", full)},
            prog.programs["tracked"])
        return prog
    forward = prog.programs["forward"]

    def call(images):
        got = images.shape[0]
        if got == saved:
            return forward(images)
        if not pad_batch:
            raise ValueError(f"the artifact was saved for batch {saved}, "
                             f"got {got} (attach with pad_batch=True to "
                             f"pad smaller batches)")
        if got > saved:
            raise ValueError(f"batch {got} exceeds the artifact's saved "
                             f"batch {saved}")
        pad = images.new_zeros((saved - got,) + tuple(images.shape[1:]))
        out = forward(torch.cat([images, pad]))
        return type(out)(*(f[:got] for f in out))

    obj._programs[hw] = call
    return prog
