"""tpu_face_torch.aot (torch.export artifacts) against the live
programs, on the CPU: the counterparts of tests/test_aot.py's cases.

* A ``FaceCascade(warp_method="pallas")`` artifact (two 540x360 rotated
  frames; on the CPU the kernels' operators run their plain versions):
  ``load`` and ``attach`` reproduce the live program (within 1e-6, flags
  equal; in practice bit for bit), and the same frames through
  ``tpu_face.pipeline.FaceCascade`` agree within the cascade contract
  (tests/test_torch_cascade.py: 0.25 px, 1e-3).
* The artifact is pickle-free (magic, JSON header, the graphs as JSON and
  the tensors' raw bytes, nothing else), ``load`` never calls
  ``torch.load``, and it refuses a pickle, a ``torch.save`` file and junk.
* ``attach`` rejects another class, layout, device type or
  ``max_faces``, and anything but a cascade or a tracker; a call at
  another batch names the saved batch; ``pad_batch`` (HWC and planar).
* ``EmbedCascade`` with the demo embedding graph.
* The trackers' artifacts are in tests/test_torch_aot_tracking.py.
* ``kind="executable"`` artifacts are in tests/test_torch_aot_executable.py.
* The tensor table stores each of many short-lived tensors, however the
  allocator reuses their addresses.
* ``infer_sharded`` refuses a cascade with an attached artifact.
"""

import json
import pickle
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
import tpu_face
from test_rotation_e2e import ROT
from test_torch_cascade import _compare
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch import aot
from tpu_face_torch.parallel import infer_sharded
from tpu_face_torch.pipeline import EmbedCascade, FaceCascade
from tpu_face_torch.tracking import FaceTracker
from tpu_face_torch.utils.image_io import load_image

SIZE = (540, 360)
NAMES = ["man_rotm15.png", "man_rotp30.png"]
DEMO = str(Path(tpu_face.__file__).parent / "data" / "demo")


def _close(live, out, tol=1e-6):
    """Every field of ``out`` within ``tol`` of ``live``'s; bools equal."""
    assert live._fields == out._fields
    for f, a, b in zip(live._fields, live, out):
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype == torch.bool:
            assert torch.equal(a, b), f
        else:
            assert float((a - b).abs().max()) <= tol, f


@pytest.fixture(scope="module")
def frames():
    return np.stack([load_image(ROT / n) for n in NAMES])


def _cascade(**kw):
    return FaceCascade(warp_method="pallas", device="cpu", **kw)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, frames):
    """(path, live result): the cascade exported once per module."""
    cascade = _cascade()
    live = cascade.infer_batch(frames)
    b, h, w, _ = frames.shape
    p = aot.save(cascade, tmp_path_factory.mktemp("aot") / "cascade.aot",
                 batch=b, height=h, width=w)
    return p, live


@pytest.fixture(scope="module")
def attached(artifact):
    """(cascade, LoadedProgram): a fresh cascade with the module's
    artifact attached, loaded once for every test that runs it."""
    p, _ = artifact
    fresh = _cascade()
    return fresh, aot.attach(fresh, p)


def test_cascade_roundtrip_and_attach(artifact, attached, frames):
    p, live = artifact
    assert p.stat().st_size > 1_000_000  # weights baked in
    prog = aot.load(p)
    assert prog.meta["cls"] == "FaceCascade"
    assert prog.meta["layout"] == "hwc"
    assert prog.meta["device"] == "cpu"
    assert [q["name"] for q in prog.meta["programs"]] == ["forward"]
    with torch.inference_mode():
        _close(live, prog(torch.from_numpy(frames)))

    fresh, prog = attached
    assert prog.meta["cls"] == "FaceCascade"
    assert (360, 540) in fresh._programs
    _close(live, fresh.infer_batch(frames))


def test_live_and_attached_match_jax(artifact, attached, frames):
    _, live = artifact
    ref = JaxFaceCascade(warp_method="gather").infer_batch(frames)
    _compare(live, ref, SIZE)
    _compare(attached[0].infer_batch(frames), ref, SIZE)


def test_artifact_is_pickle_free(artifact, tmp_path, monkeypatch):
    p, _ = artifact
    raw = p.read_bytes()
    assert raw.startswith(aot._MAGIC)
    start = len(aot._MAGIC)
    (n,) = struct.unpack(">Q", raw[start:start + 8])
    meta = json.loads(raw[start + 8:start + 8 + n])
    assert meta["kind"] == "export"
    # the payload is the graphs (JSON) and the tensors' bytes, nothing else
    payload = raw[start + 8 + n:]
    graphs = sum(q["graph_bytes"] for q in meta["programs"])
    json.loads(payload[:graphs])
    assert len(payload) == graphs + sum(t["bytes"] for t in meta["tensors"])

    def no_torch_load(*args, **kwargs):
        raise AssertionError("aot.load must not call torch.load")

    monkeypatch.setattr(torch, "load", no_torch_load)
    aot.load(p)
    monkeypatch.undo()

    evil = tmp_path / "evil.aot"
    evil.write_bytes(pickle.dumps({"meta": {"format": "x"}}))
    saved = tmp_path / "saved.aot"
    torch.save({"w": torch.zeros(3)}, saved)
    junk = tmp_path / "junk.aot"
    junk.write_bytes(b"PNG\x89 definitely not an artifact")
    bad_head = tmp_path / "bad_head.aot"
    bad_head.write_bytes(aot._MAGIC + struct.pack(">Q", 5) + b"{nope")
    for path in (evil, saved, junk, bad_head):
        with pytest.raises(ValueError, match="artifact"):
            aot.load(path)


def _with_meta(src, dst, **changes):
    """A copy of artifact ``src`` at ``dst`` with header fields changed."""
    raw = src.read_bytes()
    start = len(aot._MAGIC)
    (n,) = struct.unpack(">Q", raw[start:start + 8])
    meta = json.loads(raw[start + 8:start + 8 + n])
    meta.update(changes)
    head = json.dumps(meta).encode()
    dst.write_bytes(raw[:start] + struct.pack(">Q", len(head)) + head
                    + raw[start + 8 + n:])
    return dst


def test_attach_rejects_mismatches(artifact, tmp_path):
    p, _ = artifact
    with pytest.raises(ValueError, match="FaceCascade"):
        aot.attach(FaceTracker(device="cpu"), p)
    with pytest.raises(ValueError, match="layout"):
        aot.attach(_cascade(input_layout="planar"), p)
    with pytest.raises(ValueError, match="device type"):
        aot.attach(_cascade(), _with_meta(p, tmp_path / "cuda.aot",
                                          device="cuda"))
    with pytest.raises(ValueError, match="max_faces"):
        aot.attach(_cascade(max_faces=2), p)
    with pytest.raises(TypeError):
        aot.attach(object(), p)
    with pytest.raises(TypeError):
        aot.save(object(), tmp_path / "x.aot", batch=1, height=8, width=8)


def test_attach_pad_batch(artifact, attached, frames):
    """pad_batch=True: a 1-frame call rides the saved batch-2 program
    (zero-padded, result sliced back), within 1e-6 of the live result;
    exact-size calls pass through; oversize batches raise; without it a
    smaller batch raises naming the saved batch."""
    p, live = artifact
    fresh = _cascade()
    aot.attach(fresh, p, pad_batch=True)
    out = fresh.infer_batch(frames[:1])
    assert out.mesh.shape[0] == 1
    _close(type(live)(*(f[:1] for f in live)), out)
    _close(live, fresh.infer_batch(frames))
    with pytest.raises(ValueError, match="exceeds"):
        fresh.infer_batch(np.concatenate([frames, frames]))
    strict, _ = attached
    with pytest.raises(ValueError, match="batch 2"):
        strict.infer_batch(frames[:1])
    with pytest.raises(ValueError, match="pad_batch"):
        aot.attach(FaceTracker(device="cpu"), p, pad_batch=True)


def test_attach_pad_batch_planar(tmp_path, frames):
    """pad_batch pads axis 0 of [B, 3, H, W] planar input too."""
    planar = np.ascontiguousarray(frames.transpose(0, 3, 1, 2))
    b, _, h, w = planar.shape
    cascade = _cascade(input_layout="planar")
    live = cascade.infer_batch(planar)
    p = aot.save(cascade, tmp_path / "planar.aot", batch=b, height=h,
                 width=w)
    fresh = _cascade(input_layout="planar")
    aot.attach(fresh, p, pad_batch=True)
    _close(type(live)(*(f[:1] for f in live)), fresh.infer_batch(planar[:1]))


def test_embed_cascade_roundtrip(tmp_path, frames):
    b, h, w, _ = frames.shape
    cas = EmbedCascade(embed_model_path=DEMO, warp_method="pallas",
                       device="cpu")
    live = cas.infer_batch(frames)
    p = aot.save(cas, tmp_path / "embed.aot", batch=b, height=h, width=w)
    fresh = EmbedCascade(embed_model_path=DEMO, warp_method="pallas",
                         device="cpu")
    prog = aot.attach(fresh, p)
    assert prog.meta["cls"] == "EmbedCascade"
    out = fresh.infer_batch(frames)
    assert type(out).__name__ == "EmbedResult"
    _close(live, out)
    assert bool(out.face_valid.all())


def test_tensor_table_keeps_freed_tensors_apart():
    # each tensor is freed once added, so the allocator may hand its
    # address to the next: the table must still store every one
    table = aot._Tensors()
    for n in range(64):
        assert table.add(torch.full((4096,), float(n))) == n
    for n, blob in enumerate(table.blobs):
        assert (np.frombuffer(blob, np.float32) == n).all()


def test_infer_sharded_refuses_attached(artifact, attached, frames):
    _, live = artifact
    fresh, _ = attached
    with pytest.raises(ValueError, match="attached artifact"):
        infer_sharded(fresh, frames, ["cpu", "cpu"])
    _close(live, fresh.infer_batch(frames))
