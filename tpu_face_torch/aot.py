"""Ahead-of-time programs: a cascade's or a tracker's batched program as
a ``torch.export`` artifact or a compiled AOTInductor package
(counterpart of tpu_face/aot.py).

``save()`` traces ``obj``'s program at one (batch, height, width) with
``torch.export`` and writes it, the weights as constants, into one file;
``load()`` reads it back into a ``LoadedProgram``; ``attach()`` installs
the loaded programs into a live cascade or tracker, so that the ordinary
host API (``__call__`` / ``infer_batch`` / ``step``) runs them instead of
its Python stages.  The kernels are registered operators
(``torch.ops.tpu_face_torch.*``), so a program exported on the card
launches the same kernels as the live cascade, one operator node per
warp launch and per fused residual run.

A cascade's artifact holds one program, its ``_forward``.  A tracker's
holds one program, "step": its whole ``_step_fn``, the two decisions
``torch.cond`` nodes (``programs.cond`` while ``torch.export`` traces),
as the JAX package exports the jitted step.  It takes JAX's inputs in
JAX's order, (images, roi [B, 5], valid [B], force []) for a
``FaceTracker`` and (images, rois [B, K, 5], valid [B, K], locked [B],
force []) for a ``MultiFaceTracker``, and returns (result, next state).
Both kinds read each predicate on the host when they run (an export's
graph runs ``torch.cond`` eagerly, an executable's compiled wrapper
branches on it), as XLA's GPU conditional does: two reads a step.

Kinds:

- ``"export"`` (the default): the ``torch.export`` program, the
  counterpart of the JAX package's ``"stablehlo"``.  It is not
  StableHLO, so it does not take that name.  A loaded program runs the
  graph's ATen calls one by one from Python.
- ``"executable"``: each exported program compiled by AOTInductor
  (``torch._inductor.aoti_compile_and_package``, TF32 off) into a
  package whose compiled wrapper runs the whole program without Python
  per op, the counterpart of a serialized XLA executable.  The kernels'
  operators stay opaque nodes: the package calls their registered
  implementations, so it launches the same hand-written kernels as the
  live object.  Inductor compiles the ATen part, fusing elementwise
  chains, so the result is held to the cascade's accuracy contract, not
  to bit identity with the live object.  An executable is bound to its
  runtime, as an XLA executable is: the header records the device type,
  the GPU's name and compute capability (or the CPU's vector ISA) and
  the torch version, and ``load`` refuses any other before it loads a
  package.

Both kinds share one container: a magic prefix, a u64-be length, a JSON
header (the metadata and which program is which), then the payload.  An
``"export"`` payload is each program's graph as ``torch.export``'s JSON
and a table of tensors, each tensor's raw bytes stored once however
many programs read it.  ``load`` of an export never unpickles: it hands
the deserializer tensors it built from those bytes, never serialized
state for ``torch.load`` to read, so an export is safe to load from
untrusted sources.  An ``"executable"`` payload is each program's
package bytes: a package holds a compiled shared library that its load
runs, so load only executables you made yourself (the JAX package's
trust model for its executables).

An artifact is tied to its device type ("cuda" or "cpu"), its frame
geometry and its batch, as an XLA program is; ``pad_batch`` lets smaller
cascade batches ride it.
"""

import io
import json
import struct
from pathlib import Path

import numpy as np
import torch

from . import exact_f32
# (importing the pipeline registers the kernels' operators, which the
# programs call)
from .pipeline import CascadeResult, EmbedCascade, EmbedResult, _DetectorBase
from .tracking import MultiTrackerState, TrackerState, _TrackerBase

_FORMAT = "tpu-face-torch-aot-v2"
# pickle-free container: magic, u64-be header length, JSON header, payload
_MAGIC = b"TPUFACE-TORCH-AOT\x00"
KINDS = ("export", "executable")
_META_KEYS = {"cls", "batch", "height", "width", "layout", "device",
              "max_faces", "programs", "tensors"}
_RESULTS = {cls.__name__: cls for cls in (CascadeResult, EmbedResult,
                                          TrackerState, MultiTrackerState)}
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


# Inductor's options for an executable.  Its C++ wrapper is compiled and
# linked by the g++ on PATH (Inductor's own default), not by $CXX, since
# the link takes -fopenmp and a $CXX toolchain may lack GCC's OpenMP
# runtime (libgomp.spec).  Fused bf16 chains round to bf16 after every
# op, as the live nets do (without it Inductor keeps them in f32: on an
# H100 the bf16 detector's boxes and face ROIs then moved up to 2.3e-3
# from the live object's, and 2.4e-7 with it).
_INDUCTOR = {"cpp.cxx": ("g++",), "emulate_precision_casts": True}


def _compile(ep) -> bytes:
    """The AOTInductor package of exported program ``ep``, compiled under
    ``no_grad`` and full f32 (the package's matmuls and convolutions
    read the TF32 flags when they run, and ``_Program`` calls it under
    ``exact_f32`` too); a failed compile raises.  A program with
    ``torch.cond`` nodes (a tracker's step) is compiled without buffer
    reuse: torch 2.11's wrapper planning indexed past its table of lines
    when it weighed reusing a buffer across a cond's subgraphs
    (``segmented_tree.summarize_range``, an H100 build)."""
    configs = dict(_INDUCTOR)
    if any(n.target is torch.ops.higher_order.cond for n in ep.graph.nodes):
        configs["allow_buffer_reuse"] = False
    buf = io.BytesIO()
    with torch.no_grad(), exact_f32():
        torch._inductor.aoti_compile_and_package(
            ep, package_path=buf, inductor_configs=configs)
    return buf.getvalue()


def _target(device) -> dict:
    """What binds an executable compiled for ``device`` to its runtime:
    the GPU's name and compute capability, or the CPU's vector ISA (the
    package's kernels use its instructions)."""
    if device.type == "cuda":
        return {"gpu": torch.cuda.get_device_name(device),
                "capability": list(torch.cuda.get_device_capability(device))}
    from torch._inductor.cpu_vec_isa import pick_vec_isa

    return {"cpu_isa": str(pick_vec_isa())}


def _check_target(meta, device):
    """Refuse (``ValueError``) to load an executable on another device
    type, GPU, compute capability, CPU vector ISA or torch version than
    the one it was compiled for."""
    if meta["device"] != device.type:
        raise ValueError(f"the executable was compiled for device type "
                         f"{meta['device']!r}, not {device.type!r}")
    if meta.get("torch") != torch.__version__:
        raise ValueError(f"the executable was compiled with torch "
                         f"{meta.get('torch')}, not {torch.__version__}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("the executable was compiled for a CUDA device, "
                         "and none is available")
    here = _target(device)
    for key, value in here.items():
        if meta.get(key) != value:
            raise ValueError(f"the executable was compiled for {key} "
                             f"{meta.get(key)!r}, not {value!r}")


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
    ``path``; with ``kind="executable"`` compile each one into an
    AOTInductor package (on ``obj``'s device: the card's compile runs
    Inductor's code generation and its CUDA and C++ compilers).

    ``obj``: a ``FaceCascade`` or ``EmbedCascade``, a ``FaceTracker`` or
    a ``MultiFaceTracker``.  The batch size and frame geometry are baked
    into the artifact; save one artifact per serving configuration.  The
    programs run on the device type ``obj`` runs on."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    from torch._export.serde import serialize as serde

    path = Path(path)
    tensors = _Tensors()
    blobs, programs = [], []
    for name, (module, args) in _modules(obj, batch, height, width).items():
        ep = _export(module, args)
        prog = {"name": name, "batch": int(args[0].shape[0]),
                "inputs": [[str(a.dtype), list(a.shape)] for a in args],
                "result": ("EmbedResult" if isinstance(obj, EmbedCascade)
                           else "CascadeResult")}
        if isinstance(obj, _TrackerBase):
            # the step returns (result, next state)
            prog["state"] = obj._State.__name__
        if kind == "executable":
            blobs.append(_compile(ep))
            prog["package_bytes"] = len(blobs[-1])
            programs.append(prog)
            continue
        for fqn, value in (*ep.state_dict.items(), *ep.constants.items()):
            if not isinstance(value, torch.Tensor):
                raise ValueError(f"{name}: constant {fqn} is a "
                                 f"{type(value).__name__}, not a tensor")
        # the graph's JSON only: the weights go into the tensor table
        blobs.append(serde.serialize(ep).exported_program)
        programs.append({
            **prog, "graph_bytes": len(blobs[-1]),
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
    if kind == "executable":
        meta.update(_target(obj.device))
    if isinstance(obj, _TrackerBase):
        meta["repair_batch"] = obj._repair_n(batch)
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">Q", len(head)))
        f.write(head)
        for blob in blobs + tensors.blobs:
            f.write(blob)
    return path


class _Program:
    """One loaded program: ``__call__(*tensors)`` checks its inputs
    against the saved ones, runs ``module`` (an exported program's
    module or a loaded AOTInductor package) under ``inference_mode`` and
    full f32 and returns the result NamedTuple, or (result, state) where
    the program returns a tracker's next state too."""

    def __init__(self, name, module, inputs, result, state=None):
        self.name = name
        self.module = module
        self.inputs = inputs
        self.result = result
        self.state = state

    @property
    def batch(self):
        """The saved batch: the first input's leading dimension."""
        return self.inputs[0][1][0]

    def __call__(self, *args):
        got = [[str(a.dtype), list(a.shape)] for a in args]
        if got != self.inputs:
            raise ValueError(f"the artifact's {self.name} program takes "
                             f"{self.inputs} (dtype, shape); got {got}")
        with torch.inference_mode(), exact_f32():
            out = self.module(*args)
        if self.state is None:
            return self.result(*out)
        n = len(self.result._fields)
        return self.result(*out[:n]), self.state(*out[n:])


def _returns(prog):
    """(result type, state type or None) of header entry ``prog``; an
    unknown name raises ``KeyError``."""
    state = prog.get("state")
    return (_RESULTS[prog["result"]],
            None if state is None else _RESULTS[state])


class LoadedProgram:
    """A deserialized artifact: ``meta`` (the JSON header) and
    ``programs`` {name: callable}.  Calling it runs the first program on
    exactly the tensors it was saved with: a cascade's ``forward`` on
    the frames, a tracker's ``step`` on (images, roi, valid, force) or
    (images, rois, valid, locked, force), returning (result, state)."""

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
    if not isinstance(meta, dict):
        raise _not_artifact(path, "bad header")
    if meta.get("format") != _FORMAT:
        raise _not_artifact(path, f"format {meta.get('format')!r}; save it "
                            f"again")
    if meta.get("kind") not in KINDS or not _META_KEYS <= set(meta):
        raise _not_artifact(path, "bad format")
    return meta, payload


def _programs(path, meta, payload, device):
    """{name: _Program} of an artifact read by ``_read``, its tensors (or
    an executable's packages) on ``device``."""
    if meta["kind"] == "executable":
        return _packages(path, meta, payload, device)
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
                prog["name"], ep.module(), prog["inputs"], *_returns(prog))
    except Exception as e:   # untrusted input: any failure is a bad file
        raise _not_artifact(path, f"{type(e).__name__}: {e}") from e
    return programs


def _load_package(blob, device):
    """The AOTInductor package ``blob`` (``_compile``'s bytes) loaded on
    ``device``."""
    index = -1 if device.index is None else device.index
    return torch._inductor.aoti_load_package(io.BytesIO(blob),
                                             device_index=index)


def _packages(path, meta, payload, device):
    """{name: _Program} of an executable read by ``_read``, loaded on
    ``device`` once its header has passed ``_check_target``."""
    _check_target(meta, device)
    try:
        sizes = [int(prog["package_bytes"]) for prog in meta["programs"]]
        returns = [_returns(prog) for prog in meta["programs"]]
    except (KeyError, TypeError, ValueError) as e:
        raise _not_artifact(path, "bad program table") from e
    if min(sizes, default=0) <= 0 or sum(sizes) != len(payload):
        raise _not_artifact(path, f"{len(payload)} payload bytes, the "
                            f"header gives {sum(sizes)}: truncated")
    programs, start = {}, 0
    for prog, n, ret in zip(meta["programs"], sizes, returns):
        module = _load_package(bytes(payload[start:start + n]), device)
        start += n
        programs[prog["name"]] = _Program(prog["name"], module,
                                          prog["inputs"], *ret)
    return programs


def load(path) -> LoadedProgram:
    """Read an artifact written by ``save``, its tensors on the device
    type it was saved on.  Anything else, pickles included, raises
    ``ValueError``; an export's load unpickles nothing.  An executable's
    header must name this runtime (``_check_target``); its packages'
    compiled code runs when they load, so load only executables you
    made."""
    path = Path(path)
    meta, payload = _read(path)
    return LoadedProgram(meta, _programs(path, meta, payload,
                                         torch.device(meta["device"])))


def attach(obj, path, pad_batch: bool = False) -> LoadedProgram:
    """Load an artifact and install its programs as ``obj``'s for the
    saved geometry, so the normal host API runs them (no Python stages).

    The artifact must come from the same class, input layout, device
    type and ``max_faces`` (a tracker's also from the same repair batch),
    and an executable from this runtime (``load``); its packages load on
    ``obj``'s device.  A call at another batch then raises
    ``ValueError`` naming the saved batch.  ``pad_batch=True`` (cascades
    only: trackers carry per-stream state, where padding would corrupt
    the lock bookkeeping) lets smaller batches ride the fixed-batch
    program: frames are zero-padded up to the saved batch and the result
    sliced back; a larger batch raises ("exceeds")."""
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
        obj._programs[hw] = prog.programs["step"]
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
