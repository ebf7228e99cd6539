"""The command line: ``python -m tpu_face_torch <command> ...``
(counterpart of ``python -m tpu_face``).

The reference ships only (stale) example binaries
(reference: examples/face_detection.rs:6-18, examples/face_landmark.rs:6-21);
this CLI exposes the same flows as subcommands with JSON output and
optional annotated-PNG rendering, on the CUDA card or, with
``--device cpu``, on the CPU:

    python -m tpu_face_torch detect  IMG [--model back] [--render out.png]
    python -m tpu_face_torch mesh    IMG [--render out.png]
    python -m tpu_face_torch iris    IMG [--render out.png]
    python -m tpu_face_torch embed   IMG1 IMG2 [--model-path DIR]
    python -m tpu_face_torch cascade IMG... [--max-faces K]
    python -m tpu_face_torch identify IMG... [--embed-model-path DIR]
    python -m tpu_face_torch track   STREAM.mjpeg | FRAME... [--smooth]
    python -m tpu_face_torch info

``detect`` prints every detection (score, bbox, 6 keypoints);
``mesh`` adds the 468-point face mesh for the best face; ``iris`` runs
the full cascade (detect -> mesh -> both irises, the reference's
integration flow lib.rs:18-84) and renders the bbox+mesh+iris overlay.
Coordinates in the JSON are normalized to the image; pass ``--pixels``
for absolute pixel values.  The arguments and the JSON lines are the JAX
CLI's; ``--device`` (every command; default: the CUDA card) is the
counterpart of ``JAX_PLATFORMS``: without a card and without
``--device cpu`` a command raises instead of falling back.
"""

import argparse
import json
import os
import sys

import numpy as np


def _np(t):
    """A result field (a tensor on any device) as a numpy array."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _load(path):
    from .utils.image_io import load_image

    img = load_image(path)
    h, w = img.shape[:2]
    return img, (w, h)


def _det_json(d, size, pixels):
    sx, sy = size if pixels else (1.0, 1.0)
    return {
        "score": round(float(d.score), 4),
        "bbox": [round(float(v), 4) for v in
                 (d.bbox().xmin * sx, d.bbox().ymin * sy,
                  d.bbox().xmax * sx, d.bbox().ymax * sy)],
        "keypoints": [[round(float(d.keypoint(i)[0]) * sx, 4),
                       round(float(d.keypoint(i)[1]) * sy, 4)]
                      for i in range(6)],
    }


def _lmk_json(lmks, size, pixels):
    sx, sy = size if pixels else (1.0, 1.0)
    return [[round(l.x * sx, 4), round(l.y * sy, 4), round(l.z, 4)]
            for l in lmks]


def _load_same_size(paths):
    """Load a same-sized image batch; returns (imgs, size) or (None,
    None) after printing the JSON error (batched programs are
    static-shape)."""
    imgs, size = [], None
    for path in paths:
        img, s = _load(path)
        if size is None:
            size = s
        elif s != size:
            print(json.dumps({"error": f"{path} is {s}, batch is "
                                       f"{size} — same-size images "
                                       f"only"}))
            return None, None
        imgs.append(img)
    return imgs, size


def _model_enum(name):
    from .models import FaceDetectionModel

    return {"front": FaceDetectionModel.FRONT_CAMERA,
            "back": FaceDetectionModel.BACK_CAMERA,
            "short": FaceDetectionModel.SHORT,
            "full": FaceDetectionModel.FULL,
            "full_sparse": FaceDetectionModel.FULL_SPARSE}[name]


def cmd_detect(args):
    from .models import FaceDetection

    img, size = _load(args.image)
    faces = FaceDetection(_model_enum(args.model),
                          model_path=args.model_path,
                          device=args.device).infer(img)
    out = {"image": args.image, "faces":
           [_det_json(f, size, args.pixels) for f in faces]}
    if args.render:
        from .render import Colors, detections_to_render_data, \
            render_to_image
        anns = detections_to_render_data(faces,
                                         bounds_color=Colors.GREEN,
                                         line_width=4)
        render_to_image(anns, img).save(args.render)
        out["render"] = args.render
    print(json.dumps(out))
    return 0


def cmd_mesh(args):
    from .models import (FaceDetection, FaceLandmark,
                         face_detection_to_roi)

    img, size = _load(args.image)
    faces = FaceDetection(_model_enum(args.model),
                          model_path=args.model_path,
                          device=args.device).infer(img)
    if not faces:
        print(json.dumps({"image": args.image, "faces": []}))
        return 1
    roi = face_detection_to_roi(faces[0], size)
    mesh = FaceLandmark(model_path=args.model_path,
                        device=args.device).infer(img, roi)
    out = {"image": args.image,
           "face": _det_json(faces[0], size, args.pixels),
           "mesh": _lmk_json(mesh, size, args.pixels)}
    if args.render:
        from .models import face_landmarks_to_render_data
        from .render import Colors, render_to_image
        anns = face_landmarks_to_render_data(mesh, Colors.RED,
                                             Colors.RED)
        render_to_image(anns, img).save(args.render)
        out["render"] = args.render
    print(json.dumps(out))
    return 0


def cmd_iris(args):
    from .models import (FaceDetection, FaceLandmark, IrisLandmark,
                         face_detection_to_roi, get_iris_diameter,
                         iris_roi_from_face_landmarks,
                         update_face_landmarks_with_iris_results)

    img, size = _load(args.image)
    faces = FaceDetection(_model_enum(args.model),
                          model_path=args.model_path,
                          device=args.device).infer(img)
    if not faces:
        print(json.dumps({"image": args.image, "faces": []}))
        return 1
    roi = face_detection_to_roi(faces[0], size)
    mesh = FaceLandmark(model_path=args.model_path,
                        device=args.device).infer(img, roi)
    l_roi, r_roi = iris_roi_from_face_landmarks(mesh, size)
    iris = IrisLandmark(model_path=args.model_path, device=args.device)
    left = iris.infer(img, l_roi)
    right = iris.infer(img, r_roi, is_right_eye=True)
    refined = update_face_landmarks_with_iris_results(mesh, left, right)
    out = {"image": args.image,
           "face": _det_json(faces[0], size, args.pixels),
           "mesh": _lmk_json(refined, size, args.pixels),
           "iris_left": _lmk_json(left.iris, size, args.pixels),
           "iris_right": _lmk_json(right.iris, size, args.pixels),
           "iris_diameter_px": [
               round(get_iris_diameter(left.iris, size), 2),
               round(get_iris_diameter(right.iris, size), 2)]}
    if args.render:
        from .models import (eye_landmarks_to_render_data,
                             face_landmarks_to_render_data)
        from .render import Colors, detections_to_render_data, \
            render_to_image
        anns = detections_to_render_data(faces,
                                         bounds_color=Colors.GREEN,
                                         line_width=4)
        anns = face_landmarks_to_render_data(refined, Colors.RED,
                                             Colors.RED, output=anns)
        anns = eye_landmarks_to_render_data(left.eyeball_contour(),
                                            Colors.BLUE, Colors.BLUE,
                                            output=anns)
        anns = eye_landmarks_to_render_data(right.eyeball_contour(),
                                            Colors.BLUE, Colors.BLUE,
                                            output=anns)
        render_to_image(anns, img).save(args.render)
        out["render"] = args.render
    print(json.dumps(out))
    return 0


def cmd_embed(args):
    from .models import FaceDetection, FaceEmbeddings
    from .utils.image_io import similarity_score

    try:
        emb = FaceEmbeddings(model_path=args.model_path,
                             device=args.device)
    except FileNotFoundError as e:
        # like the reference, the embeddings model is not bundled
        # (reference README.md:9-10); point at the converter
        print(json.dumps({"error": str(e)}))
        return 1
    det = FaceDetection(_model_enum(args.model),
                        model_path=args.model_path, device=args.device)
    vecs = []
    for path in (args.image, args.image2):
        img, size = _load(path)
        faces = det.infer(img)
        if not faces:
            print(json.dumps({"image": path, "error": "no face"}))
            return 1
        bbox = faces[0].bbox().scale(size)
        vecs.append(emb.infer(img, bbox))
    sim = similarity_score(vecs[0], vecs[1])
    print(json.dumps({"images": [args.image, args.image2],
                      "dim": int(vecs[0].shape[-1]),
                      "cosine_similarity": round(float(sim), 4)}))
    return 0


def cmd_cascade(args):
    """Batched pipeline: all images in one ``FaceCascade`` call (the
    serving path), one JSON line per image."""
    from .pipeline import FaceCascade

    imgs, size = _load_same_size(args.images)
    if imgs is None:
        return 1
    batch = np.stack(imgs)
    cascade = FaceCascade(_model_enum(args.model),
                          model_path=args.model_path,
                          max_faces=args.max_faces, device=args.device)
    res = cascade.infer_batch(batch)
    w, h = size
    sx, sy = (w, h) if args.pixels else (1.0, 1.0)
    for i, path in enumerate(args.images):
        det = _np(res.detection[i]).reshape(-1, 8, 2)
        score = _np(res.score[i]).reshape(-1)
        valid = _np(res.mesh_valid[i]).reshape(-1)
        fvalid = _np(res.face_valid[i]).reshape(-1)
        mesh = _np(res.mesh[i]).reshape(-1, 468, 3)
        iris = _np(res.iris[i]).reshape(-1, 2, 5, 3)
        faces = []
        for f in range(det.shape[0]):
            if not fvalid[f]:
                continue
            faces.append({
                "score": round(float(score[f]), 4),
                "bbox": [round(float(v) * s, 4) for v, s in
                         zip(det[f, :2].reshape(-1), (sx, sy, sx, sy))],
                "mesh_valid": bool(valid[f]),
                "nose": [round(float(mesh[f, 1, 0]) * sx, 4),
                         round(float(mesh[f, 1, 1]) * sy, 4)],
                "iris_centers": [
                    [round(float(iris[f, e, 0, 0]) * sx, 4),
                     round(float(iris[f, e, 0, 1]) * sy, 4)]
                    for e in range(2)],
            })
        print(json.dumps({"image": path, "faces": faces}))
    return 0


def cmd_identify(args):
    """Detect -> crop -> embed (pipeline.EmbedCascade) over many
    same-sized images in one call, one JSON line per image plus the
    pairwise cosine matrix."""
    from .models.face_detection import _DATA_DIR
    from .pipeline import EmbedCascade

    imgs, size = _load_same_size(args.images)
    if imgs is None:
        return 1
    demo = _DATA_DIR / "demo"
    embed_path = args.embed_model_path or args.model_path
    demo_weights = embed_path is None
    if demo_weights:
        embed_path = str(demo)
    try:
        cas = EmbedCascade(_model_enum(args.model),
                           model_path=args.model_path,
                           embed_model_path=embed_path,
                           device=args.device)
    except FileNotFoundError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    res = cas.infer_batch(np.stack(imgs))
    valid = _np(res.face_valid).reshape(len(imgs))
    score = _np(res.score).reshape(len(imgs))
    crops = _np(res.crop_bbox).reshape(len(imgs), 4)
    embs = _np(res.embedding).reshape(len(imgs), -1)
    for i, path in enumerate(args.images):
        rec = {"image": path, "face": bool(valid[i])}
        if valid[i]:
            rec.update(score=round(float(score[i]), 4),
                       crop_bbox=[round(float(v), 1) for v in crops[i]],
                       dim=int(embs.shape[1]))
        if demo_weights:
            rec["demo_weights"] = True   # similarities NOT semantic
        print(json.dumps(rec))
    sims = []
    for i in range(len(imgs)):
        for j in range(i + 1, len(imgs)):
            if valid[i] and valid[j]:
                sims.append({"pair": [args.images[i], args.images[j]],
                             "cosine_similarity":
                                 round(float(embs[i] @ embs[j]), 4)})
    if sims:
        print(json.dumps({"pairs": sims, "demo_weights": demo_weights}))
    return 0


def cmd_track(args):
    """Video tracking over an MJPEG stream or a frame sequence: one
    JSON line per frame (detector runs only on lock loss), stateful
    across the whole input — the CLI face of tracking.FaceTracker /
    MultiFaceTracker (reference has no video mode)."""
    from .tracking import FaceTracker, MultiFaceTracker

    planar = False
    if (len(args.frames) == 1
            and args.frames[0].lower().endswith((".mjpeg", ".mjpg"))):
        from .utils import native_loader
        if not native_loader.available():
            print(json.dumps({"error": "native loader unavailable "
                                       "(it needs g++ and libjpeg)"}))
            return 1
        data = open(args.frames[0], "rb").read()
        jpegs = native_loader.mjpeg_split(data)
        if not jpegs:
            print(json.dumps({"error": "no JPEG frames in stream"}))
            return 1
        info = native_loader.jpeg_info(jpegs[0])
        if info is None:
            print(json.dumps({"error": "first frame is not a "
                                       "decodable JPEG"}))
            return 1
        w, h = info
        size = (w, h)
        # decode lazily, one frame per step — a long stream must not
        # be materialized in host RAM up front.  Mid-stream size
        # changes / undecodable frames fail the same way the frame-
        # sequence branch does (ValueError -> JSON error line), never
        # as silent zero-filled frames that just drop tracking lock.
        n_frames = len(jpegs)

        def _mjpeg_gen():
            for i in range(n_frames):
                finfo = native_loader.jpeg_info(jpegs[i])
                if finfo is None:
                    raise ValueError(f"frame {i} is not a decodable "
                                     f"JPEG")
                if finfo != size:
                    raise ValueError(f"frame {i} is {finfo}, stream is "
                                     f"{size} — same-size frames only")
                yield native_loader.decode_jpeg_batch(
                    jpegs[i:i + 1], w, h, planar=True, strict=True)

        frames = _mjpeg_gen()
        planar = True
    else:
        first, size = _load(args.frames[0])
        n_frames = len(args.frames)

        def _frame_gen():
            yield first[None]
            for path in args.frames[1:]:
                img, s = _load(path)
                if s != size:
                    raise ValueError(f"{path} is {s}, stream is "
                                     f"{size} — same-size frames only")
                yield img[None]

        frames = _frame_gen()

    k = args.max_faces
    smoothing = "one_euro" if args.smooth else None
    cls_kw = dict(model_path=args.model_path,
                  redetect_every=args.redetect_every,
                  input_layout="planar" if planar else "hwc",
                  smoothing=smoothing, device=args.device)
    tracker = (FaceTracker(_model_enum(args.model), **cls_kw)
               if k == 1 else
               MultiFaceTracker(_model_enum(args.model), max_faces=k,
                                **cls_kw))
    if args.render_dir:
        os.makedirs(args.render_dir, exist_ok=True)
    # real inter-frame dt for the OneEuro smoother (variable-fps
    # sources): --timestamps FILE has one monotonic seconds value per
    # frame; --fps is a fixed-rate shorthand.  Without either, the
    # smoother's configured rate applies.
    stamps = None
    if args.timestamps:
        stamps = [float(line) for line in
                  open(args.timestamps).read().split()]
        if len(stamps) < n_frames:
            print(json.dumps({"error": f"{args.timestamps} has "
                                       f"{len(stamps)} timestamps for "
                                       f"{n_frames} frames"}))
            return 1
    sx, sy = size if args.pixels else (1.0, 1.0)
    n_skipped = 0
    frame_iter = enumerate(frames)
    while True:
        try:
            i, frame = next(frame_iter)
        except StopIteration:
            break
        except ValueError as e:  # size mismatch mid-stream
            print(json.dumps({"error": str(e)}))
            return 1
        if stamps is not None:
            dt = stamps[i] - stamps[i - 1] if i else None
        else:
            dt = (1.0 / args.fps) if args.fps else None
        # a --redetect-every pass runs the detector even while locked
        forced = tracker.next_step_forced
        skipped = (not forced
                   and bool(np.asarray(tracker.tracking).size)
                   and bool(np.asarray(tracker.tracking).all()))
        res = tracker.step(frame, dt=dt)
        n_skipped += int(skipped)
        det = _np(res.detection).reshape(-1, 8, 2)
        score = _np(res.score).reshape(-1)
        valid = _np(res.mesh_valid).reshape(-1)
        mesh = _np(res.mesh).reshape(-1, 468, 3)
        faces = [{
            "score": round(float(score[f]), 4),
            "bbox": [round(float(v) * s, 4) for v, s in
                     zip(det[f, :2].reshape(-1), (sx, sy, sx, sy))],
            "nose": [round(float(mesh[f, 1, 0]) * sx, 4),
                     round(float(mesh[f, 1, 1]) * sy, 4)],
        } for f in range(det.shape[0]) if valid[f]]
        rec = {"frame": i, "detector_skipped": skipped, "faces": faces}
        if args.render_dir:
            from .models import face_landmarks_to_render_data
            from .render import Colors, render_to_image
            from .types import Landmark
            anns = None
            for f in range(det.shape[0]):
                if not valid[f]:
                    continue
                lmks = [Landmark(float(x), float(y), float(z))
                        for x, y, z in mesh[f]]
                anns = face_landmarks_to_render_data(
                    lmks, Colors.RED, Colors.RED, output=anns)
            img_hwc = (np.moveaxis(np.asarray(frame[0]), 0, -1)
                       if planar else np.asarray(frame[0]))
            out_png = os.path.join(args.render_dir, f"frame_{i:05d}.png")
            if anns is not None:
                render_to_image(anns, img_hwc).save(out_png)
                rec["render"] = out_png
        print(json.dumps(rec))
    print(json.dumps({"frames": n_frames,
                      "detector_skipped_on": n_skipped,
                      "smoothing": bool(smoothing)}))
    return 0


def cmd_info(args):
    import torch

    from . import __version__, resolve_device
    from .models.face_detection import _DATA_DIR, _MODEL_FILES
    from .utils import native_loader
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    files = {name: f"{_MODEL_FILES[_model_enum(name)]}.npz"
             for name in ("front", "back", "short", "full", "full_sparse")}
    files.update(face_landmark="face_landmark.npz",
                 iris_landmark="iris_landmark.npz",
                 face_embeddings="face_embeddings.npz",
                 face_embeddings_demo="demo/face_embeddings.npz")
    print(json.dumps({
        "version": __version__,
        "torch": torch.__version__,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "native_loader": native_loader.available(),
        "models": [name for name, f in files.items()
                   if (_DATA_DIR / f).exists()],
    }))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_face_torch",
        description=__doc__.split("\n\n")[1])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, two_images=False):
        p.add_argument("image", help="input image (jpg/png)")
        if two_images:
            p.add_argument("image2", help="second image")
        p.add_argument("--model", default="back",
                       choices=["front", "back", "short", "full",
                                "full_sparse"])
        p.add_argument("--model-path", default=None,
                       help="directory of converted .npz model graphs")
        p.add_argument("--pixels", action="store_true",
                       help="absolute pixel coordinates in the JSON")

    p = sub.add_parser("detect", help="face detection")
    common(p)
    p.add_argument("--render", help="write annotated PNG here")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("mesh", help="468-point face mesh")
    common(p)
    p.add_argument("--render", help="write annotated PNG here")
    p.set_defaults(fn=cmd_mesh)

    p = sub.add_parser("iris", help="full cascade incl. both irises")
    common(p)
    p.add_argument("--render", help="write annotated PNG here")
    p.set_defaults(fn=cmd_iris)

    p = sub.add_parser("embed",
                       help="face embedding cosine similarity")
    common(p, two_images=True)
    p.set_defaults(fn=cmd_embed)

    p = sub.add_parser("cascade",
                       help="batched cascade over many images")
    p.add_argument("images", nargs="+",
                   help="same-sized input images (one batched call)")
    p.add_argument("--model", default="back",
                   choices=["front", "back", "short", "full",
                            "full_sparse"])
    p.add_argument("--model-path", default=None)
    p.add_argument("--pixels", action="store_true")
    p.add_argument("--max-faces", type=int, default=1)
    p.set_defaults(fn=cmd_cascade)

    p = sub.add_parser("identify",
                       help="batched detect->crop->embed "
                            "(EmbedCascade); demo weights unless "
                            "--embed-model-path points at a real "
                            "converted model")
    p.add_argument("images", nargs="+",
                   help="same-sized input images (one batched call)")
    p.add_argument("--model", default="back",
                   choices=["front", "back", "short", "full",
                            "full_sparse"])
    p.add_argument("--model-path", default=None)
    p.add_argument("--embed-model-path", default=None,
                   help="directory with a converted "
                        "face_embeddings.npz (defaults to the "
                        "synthetic-weight demo graph)")
    p.set_defaults(fn=cmd_identify)

    p = sub.add_parser("track",
                       help="video tracking over an .mjpeg stream or "
                            "a same-sized frame sequence (detector "
                            "only on lock loss; one JSON line per "
                            "frame)")
    p.add_argument("frames", nargs="+",
                   help="ONE .mjpeg/.mjpg file, or ordered frame "
                        "images")
    p.add_argument("--model", default="back",
                   choices=["front", "back", "short", "full",
                            "full_sparse"])
    p.add_argument("--model-path", default=None)
    p.add_argument("--pixels", action="store_true")
    p.add_argument("--max-faces", type=int, default=1,
                   help=">1 switches to MultiFaceTracker")
    p.add_argument("--redetect-every", type=int, default=None,
                   help="force a detector pass every N frames")
    p.add_argument("--smooth", action="store_true",
                   help="OneEuro temporal landmark smoothing")
    p.add_argument("--fps", type=float, default=None,
                   help="source frame rate; sets the smoother's "
                        "time base (default: config rate 30)")
    p.add_argument("--timestamps", default=None,
                   help="file with one per-frame timestamp (seconds) "
                        "per line — real inter-frame dt for the "
                        "smoother on variable-fps sources")
    p.add_argument("--render-dir", default=None,
                   help="write per-frame mesh-overlay PNGs here")
    p.set_defaults(fn=cmd_track)

    p = sub.add_parser("info", help="version / backend / models")
    p.set_defaults(fn=cmd_info)

    for p in sub.choices.values():
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card; 'cpu' "
                            "runs the plain path on the CPU)")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
