"""The attention wrapper of the PyTorch port on the CPU: the TMA geometry it
hands the Hopper kernel, its refusals, and its plain version on the card
tests' edge inputs against the JAX package's kernel.

* ``tma_geometry``: dims (D, N, H, B), byte strides of rows, heads and
  batches, box (D, 128, 1, 1) and swizzle (2*D bytes) for both layouts,
  read from the strides the views really have: the packed ``qk[..., :C]`` /
  ``qk[..., C:]`` halves of a [B, N, 2C] projection, their transposed
  ``bhnd`` views and contiguous operands;
* a stride that is not a multiple of 16 bytes, a misaligned base, a dtype
  or D the kernel does not take, N % 8 != 0: refused before any launch
  (before the kernel library is even loaded);
* ``dense_mha`` (plain path on the CPU) against the JAX package's
  ``dense_mha(..., interpret=True)`` (the Pallas kernels in interpret mode)
  on the edge cases of ``tests/test_torch_kernels_cuda.py:MHA_CASES``, both
  layouts: max|port - jax| <= 2e-2 * max|jax| in bf16 (the plain version
  rounds the probabilities to bf16 after normalization, the Pallas kernel
  before; the same tolerance as tests/test_torch_variants.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu.ops.flash_attn as jfa
import pgtformer_tpu_torch.ops.dense_mha as dm
from tests.test_torch_kernels_cuda import MHA_CASES, mha_operands

EDGE_CASES = [c for c in MHA_CASES if c[2] != 3072]     # the full shape is the card's


def _views(qk, v, H, layout):
    B, N, C = v.shape
    split = lambda a: a.reshape(B, N, H, C // H)
    view = split if layout == "bnhd" else (lambda a: split(a).transpose(1, 2))
    return view(qk[..., :C]), view(qk[..., C:]), view(v)


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_geometry_of_packed_projection_halves(layout, D):
    B, N, H = 2, 40, 4
    C = H * D
    qk = torch.zeros((B, N, 2 * C), dtype=torch.bfloat16)
    v = torch.zeros((B, N, C), dtype=torch.bfloat16)
    q, k, vv = _views(qk, v, H, layout)
    for t, base in ((q, qk), (k, qk), (vv, v)):
        g = dm.tma_geometry(t, layout)
        row, head = (t.stride(1), t.stride(2)) if layout == "bnhd" else (t.stride(2), t.stride(1))
        assert g.dims == (D, N, H, B)
        assert g.strides == (2 * row, 2 * head, 2 * t.stride(0))
        # the views' own strides are those of the packed buffer they read
        assert g.strides == (2 * base.shape[-1], 2 * D, 2 * N * base.shape[-1])
        assert g.box == (D, dm.BOX_ROWS, 1, 1) and g.swizzle == 2 * D
        assert len(g.flat()) == 12
    assert k.data_ptr() - q.data_ptr() == 2 * C          # the second half, in place


@pytest.mark.parametrize("D", [16, 32, 64])
def test_geometry_of_contiguous_bhnd(D):
    B, H, N = 3, 2, 24
    t = torch.zeros((B, H, N, D), dtype=torch.bfloat16)
    g = dm.tma_geometry(t, "bhnd")
    assert g.dims == (D, N, H, B)
    assert g.strides == (2 * D, 2 * N * D, 2 * H * N * D)
    assert g.swizzle == {16: 32, 32: 64, 64: 128}[D]


def _refused_before_launch(monkeypatch, q, k, v, layout):
    def no_launch():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(dm, "_lib", no_launch)
    out = torch.empty_like(q)
    with pytest.raises(NotImplementedError):
        dm._launch(q, k, v, out, layout, (0, 0, 0), 0.25)


def _bad_operands():
    B, N, H, D = 1, 16, 2, 16
    C = H * D
    base = torch.zeros(4 * B * N * C + 64, dtype=torch.bfloat16)
    return {
        # rows 2*(C+4) = 72 bytes apart: not a multiple of 16
        "row stride": torch.as_strided(base, (B, N, H, D), (N * (C + 4), C + 4, D, 1)),
        # heads 2*(D+4) = 40 bytes apart
        "head stride": torch.as_strided(base, (B, N, H, D), (N * 2 * (D + 4), 2 * (D + 4),
                                                               D + 4, 1)),
        # the base 8 bytes past a 16-byte boundary
        "base": torch.as_strided(base, (B, N, H, D), (N * C, C, D, 1), 4),
        "stride along D": torch.as_strided(base, (B, N, H, D), (N * 2 * C, 2 * C, 2 * D, 2)),
        "fp32": torch.zeros((B, N, H, D)),
        "D=48": torch.zeros((B, N, H, 48), dtype=torch.bfloat16),
    }


BAD = ["row stride", "head stride", "base", "stride along D", "fp32", "D=48"]


@pytest.mark.parametrize("what", BAD)
def test_geometry_refuses(what):
    t = _bad_operands()[what]
    with pytest.raises(NotImplementedError):
        dm.tma_geometry(t, "bnhd")


@pytest.mark.parametrize("what", BAD)
def test_launch_refuses_before_the_kernel(monkeypatch, what):
    bad = _bad_operands()[what]
    good = torch.zeros(bad.shape, dtype=torch.bfloat16)
    _refused_before_launch(monkeypatch, bad, good, good, "bnhd")
    _refused_before_launch(monkeypatch, good, good, bad, "bnhd")


def test_launch_refuses_ragged_n_and_mismatched_operands(monkeypatch):
    q = torch.zeros((1, 12, 4, 16), dtype=torch.bfloat16)               # N % 8
    _refused_before_launch(monkeypatch, q, q, q, "bnhd")
    q = torch.zeros((1, 16, 4, 16), dtype=torch.bfloat16)
    _refused_before_launch(monkeypatch, q, q[:, :8], q, "bnhd")


def test_launch_reaches_the_kernel_with_what_it_takes(monkeypatch):
    """The converse: operands the kernel takes pass every check."""
    def reached():
        raise LookupError("reached")
    monkeypatch.setattr(dm, "_lib", reached)
    qk, v = (a.to(torch.bfloat16) for a in mha_operands(1, 2, 16, 32, "normal"))
    for layout in ("bnhd", "bhnd"):
        q, k, vv = _views(qk, v, 2, layout)
        with pytest.raises(LookupError):
            dm._launch(q, k, vv, torch.empty_like(q), layout, (0, 0, 0), 0.25)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("B,H,N,D,kind", EDGE_CASES)
def test_plain_path_matches_jax_on_edge_cases(B, H, N, D, kind, layout):
    qk, v = mha_operands(B, H, N, D, kind)
    qk, v = qk.to(torch.bfloat16), v.to(torch.bfloat16)
    q, k, vv = _views(qk, v, H, layout)
    scale = D ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm" if layout == "bnhd" else "bhnd,bhmd->bhnm",
                          q.double(), k.double()) * scale
    if kind == "negative":                  # the case means what it says
        assert logits.max().item() < -20
    if kind == "sharp":
        assert logits.std().item() > 20
    out = dm.dense_mha(q, k, vv, scale=scale, layout=layout)
    j = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jfa.dense_mha(j(q), j(k), j(vv), scale=scale, layout=layout,
                                   interpret=True).astype(jnp.float32))
    got = out.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), err
