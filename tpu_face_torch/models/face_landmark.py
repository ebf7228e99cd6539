"""Face-mesh constants (counterpart of tpu_face/models/face_landmark.py)."""

ROI_SCALE = (1.5, 1.5)  # reference face_landmark.rs:30
