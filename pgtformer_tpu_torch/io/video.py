"""Host-side video I/O on OpenCV's built-in FFmpeg (cv2 imported lazily)."""

from __future__ import annotations

from typing import Iterator, List, Tuple

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
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))

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


def sliding_windows(frames: Iterator[np.ndarray], radius: int = 1
                    ) -> Iterator[List[np.ndarray]]:
    """Yield (2r+1)-frame windows centered on every input frame, with
    first/last-frame duplication padding (as the reference's inference)."""
    buf: List[np.ndarray] = []
    for frame in frames:
        if not buf:
            buf = [frame] * (radius + 1)   # left padding
        else:
            buf.append(frame)
        if len(buf) == 2 * radius + 1:
            yield list(buf)
            buf.pop(0)
    if not buf:
        return
    for _ in range(radius):                # right padding
        buf.append(buf[-1])
        if len(buf) == 2 * radius + 1:
            yield list(buf)
            buf.pop(0)

