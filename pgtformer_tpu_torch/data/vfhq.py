"""VFHQ clip datasets (the port's copy of the JAX package's
``data/vfhq.py``).

Local-filesystem reconstruction of the reference's VFHQ loaders (which it
ships non-runnable against a private S3 backend).

Directory layout:
    root/
      GT/<clip>/<%08d>.png          # 512x512 HQ frames
      LR_Blind/<clip>/<%08d>.png    # optional 128x128 pre-degraded frames
      landmarks.json                # {"GT/<clip>/<frame>.png": [[x,y]*5]}

Samples are dicts of [T, H, W, 3] arrays (float32 in [0, 1], or uint8 in
[0, 255] with ``output_dtype="uint8"``):
    {'gt', 'lq' (upsampled to GT size), 'llq' (native low-res), 'path'}
matching the "UP" dataset variants every release YAML uses.

Differences from the reference (deliberate, as in the JAX package):
  * deterministic per-index PRNG (seed + index) instead of global state;
  * when LR_Blind is absent, the blind degradation is synthesized on the
    fly from ``data/degradations.py``;
  * plain-Python indexables: batching and prefetch are the caller's
    (``data/loader.py``, or ``clip_batches`` below).

One difference from the JAX package: ``get(index, seed)`` draws a sample
under an explicit sample seed, so a loader can redraw each epoch's
degradations without writing the shared ``seed`` attribute.  For the same
tree, seed and index a sample equals the JAX package's, bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from pgtformer_tpu_torch.data.align import estimate_alignment, warp_to_template
from pgtformer_tpu_torch.data.degradations import blind_degrade_clip, imresize_matlab
from pgtformer_tpu_torch.registry import DATASET_REGISTRY


def _imread_rgb(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read {path}")
    return img[..., ::-1]


class VFHQClipDataset:
    """Base clip dataset: (clip, center-frame) indexed windows of 2r+1
    frames with optional alignment and degradation."""

    def __init__(self, root: str, r: int = 1, is_aligned: bool = False,
                 degradation: str = "blr", phase: str = "train",
                 use_hflip: bool = False, upsample_lq: bool = True,
                 inter_space: int = 1, rotate_range: float = 0.0,
                 seed: int = 0, output_dtype: str = "float32"):
        assert output_dtype in ("float32", "uint8")
        # "uint8": ship [0,255] uint8 clips (4x fewer bytes to upload; the
        # train steps dequantize on the device).  `gt` round-trips exactly;
        # `lq` picks up <=0.5/255 quantization from the float upsample.
        self.output_dtype = output_dtype
        self.root = root
        self.r = r
        self.length = 2 * r + 1
        self.is_aligned = is_aligned
        self.degradation = degradation
        self.phase = phase
        self.use_hflip = use_hflip and phase == "train"
        self.upsample_lq = upsample_lq
        self.rotate_range = rotate_range
        self.seed = seed

        gt_dir = os.path.join(root, "GT")
        self.clips: List[str] = sorted(
            d for d in os.listdir(gt_dir)
            if os.path.isdir(os.path.join(gt_dir, d)))
        self.frames: Dict[str, List[str]] = {
            c: sorted(os.listdir(os.path.join(gt_dir, c)))
            for c in self.clips}

        lm_path = os.path.join(root, "landmarks.json")
        self.landmarks = {}
        if os.path.exists(lm_path):
            with open(lm_path) as f:
                self.landmarks = json.load(f)

        # (clip, center_idx) index pairs, strided by inter_space for eval
        # (reference V2TESTUP `inter_space`)
        self.index: List[Tuple[str, int]] = []
        for c in self.clips:
            n = len(self.frames[c])
            for i in range(0, n, inter_space):
                self.index.append((c, i))

    def __len__(self) -> int:
        return len(self.index)

    def _window_indices(self, clip: str, center: int) -> List[int]:
        """Center +- r, clamped at clip borders."""
        n = len(self.frames[clip])
        return [min(max(center + d, 0), n - 1)
                for d in range(-self.r, self.r + 1)]

    def _load_frames(self, sub: str, clip: str, idxs: Sequence[int]
                     ) -> List[np.ndarray]:
        out = []
        for i in idxs:
            name = self.frames[clip][i]
            out.append(_imread_rgb(os.path.join(self.root, sub, clip, name)))
        return out

    def _landmark(self, clip: str, center: int) -> Optional[np.ndarray]:
        name = self.frames[clip][center]
        key = f"GT/{clip}/{name}"
        if key in self.landmarks:
            lm = self.landmarks[key]
            if isinstance(lm, dict):
                lm = lm.get("5landmark", lm)
            return np.asarray(lm, np.float64)
        return None

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get(index)

    def get(self, index: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Sample `index` drawn under sample seed `seed` (default: the
        dataset's `seed`)."""
        seed = self.seed if seed is None else seed
        clip, center = self.index[index]
        rng = np.random.default_rng((seed, index))
        idxs = self._window_indices(clip, center)

        gt_frames = self._load_frames("GT", clip, idxs)
        matrix = None
        if self.is_aligned:
            lm = self._landmark(clip, center)
            if lm is None:
                raise KeyError(f"no landmarks for {clip}/{center} but "
                               "is_aligned=True")
            # center-frame alignment applied to the whole window
            matrix = estimate_alignment(lm)
            gt_frames = [warp_to_template(f, matrix) for f in gt_frames]

        gt = np.stack(gt_frames).astype(np.float32) / 255.0  # [T, H, W, 3]
        H, W = gt.shape[1:3]

        if self.degradation == "lr":
            # MATLAB bicubic x0.25
            llq = np.stack([imresize_matlab(f, 0.25) for f in gt])
        elif self.degradation == "blr":
            lr_dir = os.path.join(self.root, "LR_Blind", clip)
            if os.path.isdir(lr_dir):
                lq_frames = self._load_frames("LR_Blind", clip, idxs)
                if self.is_aligned:
                    m4 = estimate_alignment(self._landmark(clip, center),
                                            scale=4.0)
                    lq_frames = [warp_to_template(f, m4, (H, W), scale=4.0)
                                 for f in lq_frames]
                llq = np.stack(lq_frames).astype(np.float32) / 255.0
            else:
                # synthesize on the fly at quarter resolution
                degraded = blind_degrade_clip(gt, rng)
                llq = np.stack([
                    cv2.resize(f, (W // 4, H // 4),
                               interpolation=cv2.INTER_LINEAR)
                    for f in degraded])
        else:
            raise ValueError(self.degradation)

        if self.rotate_range > 0:
            # deterministic per-index rotation robustness eval
            # (reference V2TESTUPROTATE)
            angle = float(np.random.default_rng((seed, index, 7))
                          .uniform(-self.rotate_range, self.rotate_range))
            M = cv2.getRotationMatrix2D((W / 2, H / 2), angle, 1.0)
            gt = np.stack([cv2.warpAffine(f, M, (W, H)) for f in gt])
            llq = np.stack([
                cv2.warpAffine(f, cv2.getRotationMatrix2D(
                    (f.shape[1] / 2, f.shape[0] / 2), angle, 1.0),
                    (f.shape[1], f.shape[0])) for f in llq])

        if self.upsample_lq:
            lq = np.stack([cv2.resize(f, (W, H),
                                      interpolation=cv2.INTER_LINEAR)
                           for f in llq])
        else:
            lq = llq

        if self.use_hflip and rng.random() < 0.5:
            gt = gt[:, :, ::-1].copy()
            lq = lq[:, :, ::-1].copy()
            llq = llq[:, :, ::-1].copy()

        if self.output_dtype == "uint8":
            q = lambda a: np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
            gt, lq, llq = q(gt), q(lq), q(llq)
        return {"gt": gt, "lq": lq, "llq": llq,
                "path": f"{clip}/{self.frames[clip][center]}"}


@DATASET_REGISTRY.register(name="VFHQFULLntmeBASICV2TRAINUP")
class VFHQTrainDataset(VFHQClipDataset):
    """Training variant: hflip, error-retry with random re-index."""

    def __init__(self, root: str, **kw):
        kw.setdefault("phase", "train")
        kw.setdefault("use_hflip", True)
        super().__init__(root, **kw)

    def get(self, index: int, seed: Optional[int] = None):
        seed = self.seed if seed is None else seed
        rng = np.random.default_rng((seed, index, 13))
        for _ in range(4):
            try:
                return super().get(index, seed)
            except Exception:
                index = int(rng.integers(0, len(self)))
        return super().get(index, seed)


@DATASET_REGISTRY.register(name="VFHQFULLntmeBASICV2TESTUP")
class VFHQTestDataset(VFHQClipDataset):
    def __init__(self, root: str, **kw):
        kw.setdefault("phase", "test")
        super().__init__(root, **kw)


@DATASET_REGISTRY.register(name="VFHQFULLntmeBASICV2TESTUPROTATE")
class VFHQRotateTestDataset(VFHQClipDataset):
    def __init__(self, root: str, **kw):
        kw.setdefault("phase", "test")
        kw.setdefault("rotate_range", 30.0)
        super().__init__(root, **kw)


def clip_batches(dataset: VFHQClipDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True):
    """Collate samples into [B, T, H, W, 3] numpy batches."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    batch = []
    for i in order:
        batch.append(dataset[int(i)])
        if len(batch) == batch_size:
            yield {k: np.stack([b[k] for b in batch])
                   for k in ("gt", "lq", "llq")} | {
                       "path": [b["path"] for b in batch]}
            batch = []
    if batch and not drop_last:
        yield {k: np.stack([b[k] for b in batch])
               for k in ("gt", "lq", "llq")} | {
                   "path": [b["path"] for b in batch]}
