"""Face alignment: similarity transform to the canonical 5-point template
(the port's copy of the JAX package's ``data/align.py``).

Semantics of the reference's ``cal_warp_affine2d`` / ``warp``: an
LMEDS-estimated partial-affine to the FFHQ-style template, warped with a
constant gray border (135, 133, 132).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# canonical 512x512 5-landmark template (eyes, nose, mouth corners)
FACE_TEMPLATE_512 = np.array([
    [192.98138, 239.94708],
    [318.90277, 240.1936],
    [256.63416, 314.01935],
    [201.26117, 371.41043],
    [313.08905, 371.15118],
], np.float64)

GRAY_BORDER = (135, 133, 132)


def estimate_alignment(landmark5: np.ndarray, scale: float = 1.0
                       ) -> np.ndarray:
    """2x3 similarity matrix mapping `landmark5` onto the template/scale."""
    template = FACE_TEMPLATE_512 / scale
    lm = np.asarray(landmark5, np.float64) / scale
    matrix = cv2.estimateAffinePartial2D(lm, template, method=cv2.LMEDS)[0]
    return matrix


def warp_to_template(img: np.ndarray, matrix: np.ndarray,
                     out_hw: Tuple[int, int] = (512, 512),
                     scale: float = 1.0) -> np.ndarray:
    shape = (int(out_hw[1] / scale), int(out_hw[0] / scale))
    return cv2.warpAffine(img, matrix, shape,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=GRAY_BORDER)
