"""Host-side video I/O on OpenCV's built-in FFmpeg (cv2 imported lazily)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _cv2():
    import cv2
    return cv2


class VideoReader:
    """Streaming BGR->RGB frame reader."""

    def __init__(self, path: str):
        cv2 = _cv2()
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 25.0

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            yield frame[..., ::-1]

    def close(self):
        self.cap.release()


class VideoWriter:
    """RGB frame writer (mp4v)."""

    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int]):
        cv2 = _cv2()
        h, w = size_hw
        self.writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not self.writer.isOpened():
            raise IOError(f"cannot open video writer: {path}")

    def write(self, rgb_frame: np.ndarray):
        self.writer.write(np.ascontiguousarray(rgb_frame[..., ::-1]))

    def close(self):
        self.writer.release()
