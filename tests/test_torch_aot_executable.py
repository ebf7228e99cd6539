"""tpu_face_torch.aot's ``kind="executable"`` (compiled AOTInductor
packages), on the CPU: the counterparts of tests/test_aot.py's
executable cases.

* A small program holding one ``warp_bilinear_segments`` node and one
  ``fused_blocks`` node (the kernels' operators; on the CPU their
  implementations are the plain versions), exported and compiled by
  ``aot``'s own ``_export``/``_compile`` and loaded by ``_load_package``:
  within 1e-6 of the eager program, each operator called once per call
  (they stay opaque nodes: the package calls their registered
  implementations), with TF32 off while it compiles and, through
  ``aot._Program``, while it runs, whatever the caller's flags.
* ``load``/``attach`` refuse, with ``ValueError`` and before any package
  is loaded, an executable of another device type, GPU, compute
  capability, CPU vector ISA or torch version, a truncated one, one of
  another class, layout or ``max_faces``, and ``pad_batch`` on a tracker.
  These run on the small program's package in an executable container
  whose header names a ``FaceCascade``: every refusal reads the header
  alone.
* Marked ``slow`` (each program's AOTInductor compile takes about a
  minute and a half on this file's share of the cores, beyond its
  budget; ``chip_smoke.py`` saves and attaches the FaceCascade
  executables on the card): a ``FaceCascade`` f32 executable on two
  rotated frames against the live port (through ``attach``, with
  ``pad_batch``) and ``tpu_face``'s cascade within the cascade contract
  (0.25 px, 1e-3 rad, 1e-3), an ``EmbedCascade`` (demo graph) executable
  against the live port, and ``FaceTracker`` and
  ``MultiFaceTracker(max_faces=2)`` executables ("full", "repair" and
  "tracked") over full, tracked and repair steps against the live
  trackers.
"""

import contextlib
import json
import struct

import numpy as np
import pytest
import torch

from test_rotation_e2e import ROT
from test_torch_aot import DEMO, NAMES, SIZE, _with_meta
from test_torch_cascade import _compare
from test_torch_threads import share_cores  # noqa: F401
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch import aot
from tpu_face_torch.ops import fused_block, warp
from tpu_face_torch.pipeline import EmbedCascade, FaceCascade
from tpu_face_torch.tracking import FaceTracker, MultiFaceTracker
from tpu_face_torch.utils.image_io import load_image

CPU = torch.device("cpu")


class _Ops(torch.nn.Module):
    """One segment warp and one fused run, with ATen work around them."""

    def __init__(self, rng, c=24, layers=2):
        super().__init__()
        f32 = np.float32
        self.weights = [torch.from_numpy(a.astype(f32)) for a in (
            rng.normal(size=(layers, c, 3, 3)) * 0.2,
            rng.normal(size=(layers, c)) * 0.1,
            rng.normal(size=(layers, c, c)) * 0.2,
            rng.normal(size=(layers, c)) * 0.1)]
        (self.packed,) = fused_block.kernel_weights(*self.weights,
                                                    torch.float32)

    def forward(self, planes, xs, ys, x):
        samples = warp.warp_bilinear_segments(
            planes * 0.5, [(xs, ys, xs.shape[-1])])
        y = fused_block.fused_blocks(x + 1.0, *self.weights,
                                     weights=(self.packed,))
        return samples.sum(1), torch.tanh(y).mean((2, 3))


def _ops_inputs(rng):
    h, w = 23, 31
    f32 = np.float32
    return (torch.from_numpy(rng.uniform(0, 255, (2, 3, h, w)).astype(f32)),
            torch.from_numpy(rng.uniform(-3, w + 3, (2, 9, 7)).astype(f32)),
            torch.from_numpy(rng.uniform(-3, h + 3, (2, 9, 7)).astype(f32)),
            torch.from_numpy(rng.normal(size=(2, 24, 12, 10)).astype(f32)))


@pytest.fixture(scope="module")
def ops_package():
    """(module, inputs, package bytes, TF32 flags seen by the compile)."""
    rng = np.random.default_rng(0)
    module, args = _Ops(rng), _ops_inputs(rng)
    seen = []
    compile_package = torch._inductor.aoti_compile_and_package

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return compile_package(*a, **kw)

    torch._inductor.aoti_compile_and_package = spy
    try:
        with _tf32_on():
            blob = aot._compile(aot._export(module, args))
    finally:
        torch._inductor.aoti_compile_and_package = compile_package
    return module, args, blob, seen


@contextlib.contextmanager
def _tf32_on():
    """The caller's TF32 flags on inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _counting(monkeypatch):
    """{operator: calls}, counted at the operators' CPU implementations
    (the plain versions they call), each call's TF32 flags recorded."""
    calls = {"warp_bilinear_segments": [], "fused_blocks": []}
    for mod, name, op in (
            (warp, "warp_bilinear_segments_plain", "warp_bilinear_segments"),
            (fused_block, "fused_blocks_plain", "fused_blocks")):
        plain = getattr(mod, name)

        def spy(*a, _plain=plain, _op=op, **kw):
            calls[_op].append((torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32))
            return _plain(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


def test_operator_program_compiles_and_runs(ops_package, monkeypatch):
    module, args, blob, seen = ops_package
    assert seen == [(False, False)]          # TF32 off for the compile
    with torch.no_grad():
        want = module(*args)
    calls = _counting(monkeypatch)
    package = aot._load_package(blob, CPU)
    with torch.inference_mode():
        got = package(*args)
    assert {k: len(v) for k, v in calls.items()} == {
        "warp_bilinear_segments": 1, "fused_blocks": 1}
    for a, b in zip(want, got):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6

    # through _Program: TF32 off at every call, whatever the caller set
    inputs = [[str(a.dtype), list(a.shape)] for a in args]
    prog = aot._Program("forward", package, inputs, lambda *out: out)
    with _tf32_on():
        prog(*args)
    assert calls["fused_blocks"][-1] == (False, False)
    assert len(calls["fused_blocks"]) == 2
    with pytest.raises(ValueError, match="forward program takes"):
        prog(*args[:3], args[3][:1])


def _exec_meta(blob, args, **changes):
    """The header of an executable container around ``blob`` that names
    a 540x360 batch-2 ``FaceCascade`` on the CPU."""
    meta = {"format": aot._FORMAT, "kind": "executable",
            "cls": "FaceCascade", "batch": 2, "height": 360, "width": 540,
            "layout": "hwc", "device": "cpu", "max_faces": 1,
            "torch": torch.__version__, "tensors": [],
            "programs": [{"name": "forward", "batch": 2,
                          "inputs": [[str(a.dtype), list(a.shape)]
                                     for a in args],
                          "result": "CascadeResult",
                          "package_bytes": len(blob)}],
            **aot._target(CPU)}
    meta.update(changes)
    return meta


def _write(path, meta, payload):
    head = json.dumps(meta).encode()
    path.write_bytes(aot._MAGIC + struct.pack(">Q", len(head)) + head
                     + payload)
    return path


@pytest.fixture
def executable(ops_package, tmp_path):
    _, args, blob, _ = ops_package
    return _write(tmp_path / "exec.aot", _exec_meta(blob, args), blob)


def test_executable_container_loads(executable, ops_package):
    module, args, _, _ = ops_package
    prog = aot.load(executable)
    assert prog.meta["kind"] == "executable"
    assert prog.meta["cpu_isa"] == aot._target(CPU)["cpu_isa"]
    with torch.no_grad():
        want = module(*args)
    got = prog.programs["forward"].module(*args)
    assert float((want[0] - got[0]).abs().max()) <= 1e-6


def _no_package_load(*args, **kwargs):
    raise AssertionError("a refused executable must not load a package")


@pytest.mark.parametrize("changes,match", [
    ({"device": "cuda"}, "CUDA device"),
    ({"torch": "0.0.0"}, "torch 0.0.0"),
    ({"cpu_isa": "no vector ISA"}, "cpu_isa"),
])
def test_load_refuses_another_runtime(executable, tmp_path, monkeypatch,
                                      changes, match):
    monkeypatch.setattr(aot, "_load_package", _no_package_load)
    with pytest.raises(ValueError, match=match):
        aot.load(_with_meta(executable, tmp_path / "other.aot", **changes))


@pytest.mark.parametrize("changes,match", [
    ({}, None),
    ({"gpu": "NVIDIA A100-SXM4-80GB"}, "gpu"),
    ({"capability": [8, 0]}, "capability"),
    ({"torch": "0.0.0"}, "torch"),
])
def test_gpu_target_check(monkeypatch, changes, match):
    """An executable compiled on one card loads on the same card only
    (the card faked: this machine need not have one)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    cuda = torch.device("cuda")
    meta = {"device": "cuda", "torch": torch.__version__,
            **aot._target(cuda)}
    assert meta["gpu"] == "NVIDIA H100 80GB HBM3"
    assert meta["capability"] == [9, 0]
    meta.update(changes)
    if match is None:
        aot._check_target(meta, cuda)
        return
    with pytest.raises(ValueError, match=match):
        aot._check_target(meta, cuda)


def test_load_refuses_truncation(executable, tmp_path, monkeypatch):
    monkeypatch.setattr(aot, "_load_package", _no_package_load)
    cut = tmp_path / "cut.aot"
    cut.write_bytes(executable.read_bytes()[:-1000])
    with pytest.raises(ValueError, match="truncated"):
        aot.load(cut)


@pytest.mark.parametrize("make,kw,changes,match", [
    (FaceTracker, {}, {}, "FaceCascade"),
    (FaceCascade, {"input_layout": "planar"}, {}, "layout"),
    (FaceCascade, {"max_faces": 2}, {}, "max_faces"),
    (FaceTracker, {"pad_batch": True}, {}, "pad_batch"),
    (FaceCascade, {}, {"device": "cuda"}, "device type"),
    (FaceCascade, {}, {"torch": "0.0.0"}, "torch 0.0.0"),
])
def test_attach_refuses_mismatches(executable, tmp_path, monkeypatch, make,
                                   kw, changes, match):
    monkeypatch.setattr(aot, "_load_package", _no_package_load)
    pad = kw.pop("pad_batch", False)
    obj = make(warp_method="pallas", device="cpu", **kw)
    path = _with_meta(executable, tmp_path / "other.aot", **changes)
    with pytest.raises(ValueError, match=match):
        aot.attach(obj, path, pad_batch=pad)


# ---- whole programs: an AOTInductor compile a program ------------------


@pytest.fixture(scope="module")
def frames():
    return np.stack([load_image(ROT / n) for n in NAMES])


def _embed_close(out, live, size):
    """EmbedResult ``out`` against ``live`` within the cascade contract:
    flags equal, the detection within 0.25 px, scores within 1e-3, the
    crop boxes (absolute px) within 0.25 px and the embeddings within
    1e-3."""
    w, h = size
    assert torch.equal(out.face_valid, live.face_valid)
    ok = live.face_valid
    px = (out.detection - live.detection)[ok] * torch.tensor([w, h])
    assert float(px.abs().max()) <= 0.25
    for f, tol in (("score", 1e-3), ("crop_bbox", 0.25), ("embedding", 1e-3)):
        d = (getattr(out, f) - getattr(live, f))[ok]
        assert float(d.abs().max()) <= tol, f


@pytest.mark.slow
@pytest.mark.parametrize("cls", [FaceCascade, EmbedCascade])
def test_cascade_executable(tmp_path, frames, cls):
    b, h, w, _ = frames.shape
    kw = {"embed_model_path": DEMO} if cls is EmbedCascade else {}
    live_obj = cls(warp_method="pallas", device="cpu", **kw)
    live = live_obj.infer_batch(frames)
    p = aot.save(live_obj, tmp_path / "cascade.aot", batch=b, height=h,
                 width=w, kind="executable")
    fresh = cls(warp_method="pallas", device="cpu", **kw)
    prog = aot.attach(fresh, p, pad_batch=True)
    assert prog.meta["kind"] == "executable"
    assert prog.meta["cls"] == cls.__name__
    assert [q["name"] for q in prog.meta["programs"]] == ["forward"]
    out = fresh.infer_batch(frames)
    one = fresh.infer_batch(frames[:1])
    assert type(out) is type(live)
    if cls is EmbedCascade:
        _embed_close(out, live, SIZE)
        _embed_close(one, type(live)(*(f[:1] for f in live)), SIZE)
        return
    _compare(out, live, SIZE)
    _compare(out, JaxFaceCascade(warp_method="gather").infer_batch(frames),
             SIZE)
    _compare(one, type(live)(*(f[:1] for f in live)), SIZE)


def _steps(frames):
    """A full step, a tracked step, a repair step (stream 1 blanked) and
    a second repair step (stream 1 back)."""
    blank = frames.copy()
    blank[1] = 0
    return [frames, frames[:, :, ::-1].copy(), blank, frames]


@pytest.mark.slow
@pytest.mark.parametrize("cls,kw", [(FaceTracker, {}),
                                    (MultiFaceTracker, {"max_faces": 2})])
def test_tracker_executable(tmp_path, frames, cls, kw):
    b, h, w, _ = frames.shape
    live_obj = cls(warp_method="pallas", device="cpu", **kw)
    p = aot.save(cls(warp_method="pallas", device="cpu", **kw),
                 tmp_path / "tracker.aot", batch=b, height=h, width=w,
                 kind="executable")
    fresh = cls(warp_method="pallas", device="cpu", **kw)
    prog = aot.attach(fresh, p)
    assert sorted(q["name"] for q in prog.meta["programs"]) == [
        "full", "repair", "tracked"]
    for i, x in enumerate(_steps(frames)):
        _compare(fresh.step(x), live_obj.step(x), SIZE)
        assert (fresh.tracking == live_obj.tracking).all(), i
    assert fresh.tracking.all()
