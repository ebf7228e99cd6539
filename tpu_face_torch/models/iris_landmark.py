"""Iris-landmark constants (counterpart of tpu_face/models/iris_landmark.py):
eye-ROI scale, the eye-corner landmarks and the contour -> face-mesh
index maps of the mesh refinement."""

ROI_SCALE = (2.3, 2.3)  # 25% margin around the eye (iris_landmark.rs:27)
LEFT_EYE_START = 33  # iris_landmark.rs:29-35
LEFT_EYE_END = 133
RIGHT_EYE_START = 362
RIGHT_EYE_END = 263

# Iris-stage contour index -> face-mesh index maps (71 entries each,
# iris_landmark.rs:64-95): eye contour, then successive surrounding
# "halo" rings and the eyebrow contours.
LEFT_EYE_TO_FACE_LANDMARK_INDEX = [
    33, 7, 163, 144, 145, 153, 154, 155, 133,
    246, 161, 160, 159, 158, 157, 173,
    130, 25, 110, 24, 23, 22, 26, 112, 243,
    247, 30, 29, 27, 28, 56, 190,
    226, 31, 228, 229, 230, 231, 232, 233, 244,
    113, 225, 224, 223, 222, 221, 189,
    35, 124, 46, 53, 52, 65,
    143, 111, 117, 118, 119, 120, 121, 128, 245,
    156, 70, 63, 105, 66, 107, 55, 193,
]

RIGHT_EYE_TO_FACE_LANDMARK_INDEX = [
    263, 249, 390, 373, 374, 380, 381, 382, 362,
    466, 388, 387, 386, 385, 384, 398,
    359, 255, 339, 254, 253, 252, 256, 341, 463,
    467, 260, 259, 257, 258, 286, 414,
    446, 261, 448, 449, 450, 451, 452, 453, 464,
    342, 445, 444, 443, 442, 441, 413,
    265, 353, 276, 283, 282, 295,
    372, 340, 346, 347, 348, 349, 350, 357, 465,
    383, 300, 293, 334, 296, 336, 285, 417,
]
