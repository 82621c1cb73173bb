"""Faults planted in the port's timed path, for the tests of ``correct``
and for ``calibrate.py --fault``.  Each is one a cell can have:

* ``state``: the restorer's carried tail is never updated (video only;
  CodeFormer carries no state);
* ``half``: the entry computes the first half of its windows or faces and
  hands those out twice;
* ``altered``: the first frame of every call comes out inverted;
* ``codes``: a quarter of every frame's tokens (every other row and
  column of the code grid) is looked up at the next code, in every call:
  a fault in part of every frame.

One card holds each cell, so there is no exchange between chips to leave
out.  ``plant(driver, kind)`` is a context manager that patches the port's
classes and puts them back on leaving.
"""

from __future__ import annotations

import contextlib

KINDS = {"pgt_video": ("state", "half", "altered", "codes"),
         "codeformer_faces": ("half", "altered", "codes")}


def quarter(shape, device):
    """[h, w] mask of every other row and column: a quarter of the grid."""
    import torch
    h, w = shape
    rows = torch.arange(h, device=device)[:, None] % 2 == 0
    cols = torch.arange(w, device=device)[None, :] % 2 == 0
    return rows & cols


@contextlib.contextmanager
def _patched(cls, name, fn):
    old = cls.__dict__[name]
    setattr(cls, name, fn)
    try:
        yield
    finally:
        setattr(cls, name, old)


def plant(driver: str, kind: str):
    import torch
    if kind not in KINDS[driver]:
        raise ValueError(f"no fault {kind!r} for {driver}")
    if driver == "pgt_video":
        from pgtformer_tpu_torch.models.pgtformer import PGTFormer
        from pgtformer_tpu_torch.pipeline import VideoRestorer
        if kind == "state":
            step = VideoRestorer._step

            def stale(self, x):
                tail = self._tail
                out = step(self, x)
                self._tail = tail
                return out
            return _patched(VideoRestorer, "_step", stale)
        if kind == "codes":
            decode = PGTFormer._decode_restored

            def wrong_codes(self, codes, *a, **k):
                m = quarter(codes.shape[1:3], codes.device)[None, :, :, None]
                return decode(self, torch.where(m, (codes + 1) % self.codebook_size, codes),
                              *a, **k)
            return _patched(PGTFormer, "_decode_restored", wrong_codes)
        restore = VideoRestorer._restore

        def broken(self, windows):
            if kind == "half":
                h = windows[0].shape[0] // 2
                out = restore(self, [w[:h] for w in windows])
                return torch.cat([out, out])
            out = restore(self, windows).clone()
            out[0] = 255 - out[0]
            return out
        return _patched(VideoRestorer, "_restore", broken)

    from pgtformer_tpu_torch.models.codeformer import CodeFormer
    from pgtformer_tpu_torch.models.vqgan import VectorQuantizer
    if kind == "codes":
        lookup = VectorQuantizer.get_codebook_feat

        def wrong_codes(self, indices, shape=None):
            N, h, w = shape[:3]
            idx = indices.reshape(N, h, w)
            m = quarter((h, w), idx.device)[None]
            n = self.embedding.weight.shape[0]
            return lookup(self, torch.where(m, (idx + 1) % n, idx).reshape(indices.shape), shape)
        return _patched(VectorQuantizer, "get_codebook_feat", wrong_codes)
    forward = CodeFormer.forward

    def broken(self, x, *a, **k):
        if kind == "half":
            h = x.shape[0] // 2
            out = forward(self, x[:h], *a, **k)
            return (torch.cat([out[0], out[0]]),) + tuple(out[1:])
        out = forward(self, x, *a, **k)
        y = out[0].clone()
        y[0] = -y[0]
        return (y,) + tuple(out[1:])
    return _patched(CodeFormer, "forward", broken)
