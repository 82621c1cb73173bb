"""float32 through the kernels and the two `use_pallas` plans of the
PyTorch port, on the CPU against the JAX package.

* The kernels' fp32 forms: the plain versions of K1, K3, K4 and K2/K6 on
  fp32 input (bf16 inside, the output fp32 and unrounded) against the JAX
  Pallas kernels in interpret mode on the same fp32 input: fp32 out, within
  2e-2 * max|ref| (the rule of tests/test_torch_variants.py; the JAX
  kernels' LayerNorm eps and tanh GELU differ, ROADMAP C); the CPU path of
  each wrapper equals its plain version.
* `use_pallas=False`, the module path: `EncoderLayer` and `TDCRQVAE3` at
  the small geometry against the JAX XLA path (fp32, 1e-4 relative).  The
  stage-I step of the default plan against the JAX package's default
  trainer is tests/test_torch_train_stage1.py (one JAX compile there, not a
  second one here); here one step under each plan, losses within 2e-2.
* The two plans against each other (the counterpart of the JAX package's
  tests/test_pallas_attn.py:56): max|d| < 0.1 and mean|d| < 0.01 on unit
  normal input, as that test holds them; the same for the code transformer
  layer, and the autoencoder's latent within 2e-2 of its norm.
* `bench_train_step` and `profile_step --code` on the CPU at the small
  geometry: the records' keys; the CLIs' --fp32 with --device cuda fail on
  the missing device only; `train_cli --pallas` names its plan.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu.nn.blocks as jb
import pgtformer_tpu.nn.transformer as jt
import pgtformer_tpu.ops.flash_attn as jfa
import pgtformer_tpu.ops.pallas_attn as jpa
import pgtformer_tpu_torch.config as tcfg
import pgtformer_tpu_torch.nn.blocks as tb
import pgtformer_tpu_torch.nn.transformer as tt
from pgtformer_tpu.models.vae import TDCRQVAE3 as JaxTDCRQVAE3
from pgtformer_tpu.ops.window import relative_position_index, shifted_window_mask
from pgtformer_tpu_torch.models.vae import TDCRQVAE3
from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
from pgtformer_tpu_torch.ops import dense_mha as dm
from pgtformer_tpu_torch.ops import sw_block as sw
from pgtformer_tpu_torch.ops.window import window_partition
from pgtformer_tpu_torch.train import stages as P
from tests.test_torch_common import (  # noqa: F401
    SMALL_DISC, close, japply, one_torch_thread, random_variables, small_configs, t, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(15)
C, HEADS, T, WIN = 64, 4, 3, (4, 4)
N = T * WIN[0] * WIN[1]


def _kernel_rule(out, ref):
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    err = np.abs(out.numpy() - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def _block(seed):
    """(JAX block params, gathered [h, N, N] bias, port kernel weights) of
    one SW block with every bias and norm affine non-trivial."""
    x = np.zeros((1, T, 8, 12, C), np.float32)
    jmod = jb.SWTransformerBlock(dim=C, num_heads=HEADS, num_frames=T, window_size=WIN,
                                 mlp_ratio=1.0)
    v = random_variables(jmod, jnp.asarray(x), seed=seed)
    p = v["params"]
    idx = relative_position_index(T, T, WIN)
    rb = np.asarray(p["attn1"]["relative_position_bias_table"])[idx.reshape(-1)]
    rb = rb.reshape(N, N, HEADS).transpose(2, 0, 1)
    mod = to_port(tb.SWTransformerBlock(C, HEADS, T, WIN, (0, 0), 1.0), v)
    return p, jnp.asarray(rb), mod.kernel_weights(torch.device("cpu"))


# -- the kernels' fp32 forms -----------------------------------------------------

@pytest.mark.parametrize("shift", [(0, 0), (2, 2)])
def test_sw_block_fp32_form_matches_jax_kernel(shift):
    """K1 and K3 (the same windows as tokens) on fp32 input."""
    x = RNG.normal(size=(2, T, 8, 12, C)).astype(np.float32)
    p, rb, w = _block(1)
    mask = shifted_window_mask(T, 8, 12, WIN, shift) if any(shift) else None
    ref = jpa._pallas_sw_block_5d(jnp.asarray(x), p, rb, mask, HEADS, WIN, shift,
                                  interpret=True)
    with torch.no_grad():
        out = sw.sw_block_plain(t(x), w, shift)
        _kernel_rule(out, ref)
        assert torch.equal(sw.sw_block(t(x), w, shift), out)
        # the input is rounded to bf16 first: the same block on bf16 values
        assert torch.equal(out, sw.sw_block_plain(t(x).to(torch.bfloat16).float(), w, shift))
        rolled = np.roll(x, (-shift[0], -shift[1]), axis=(2, 3))
        tok = window_partition(t(rolled), WIN).numpy()
        ref3 = jpa._pallas_sw_block(jnp.asarray(tok), p, rb, mask, HEADS, 6, wblk=6,
                                    interpret=True)
        out3 = sw.sw_block_tokens_plain(t(tok), w, mask, 6)
        _kernel_rule(out3, ref3)
        assert torch.equal(sw.sw_block_tokens(t(tok), w, mask, 6), out3)
        assert torch.equal(out3, window_partition(
            torch.roll(out, (-shift[0], -shift[1]), dims=(2, 3)), WIN))


def test_sw_block_pair_fp32_form_matches_jax_kernel():
    """K4 on fp32 input: block 0's fp32 result rounded to bf16 as block 1's
    input, as the TPU kernel carries it."""
    x = RNG.normal(size=(2, T, 8, 12, C)).astype(np.float32)
    (p0, rb0, w0), (p1, rb1, w1) = _block(2), _block(3)
    mask = shifted_window_mask(T, 8, 12, WIN, (2, 2))
    ref = jpa._pallas_sw_block_pair_5d(jnp.asarray(x), p0, p1, rb0, rb1, mask, HEADS, WIN,
                                       interpret=True)
    with torch.no_grad():
        out = sw.sw_block_pair_plain(t(x), w0, w1, (2, 2))
        _kernel_rule(out, ref)
        assert torch.equal(sw.sw_block_pair(t(x), w0, w1, (2, 2)), out)
        two = sw.sw_block_plain(sw.sw_block_plain(t(x), w0, (0, 0)), w1, (2, 2))
        assert torch.equal(out, two)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_dense_mha_fp32_form_matches_jax_kernel(layout):
    """K2 (bhnd) and K6 (bnhd) on fp32 operands, D=64 (scale 1/8: rounding q
    before or after the scale is the same)."""
    B, H, Nt, D = 2, 2, 40, 64
    shape = (B, H, Nt, D) if layout == "bhnd" else (B, Nt, H, D)
    q, k, v = (RNG.normal(size=shape).astype(np.float32) for _ in range(3))
    jfn = jfa._dense_mha_pallas if layout == "bhnd" else jfa._dense_mha_pallas_bnhd
    ref = jfn(*(jnp.asarray(a) for a in (q, k, v)), scale=0.125, interpret=True)
    plain = dm.dense_mha_plain if layout == "bhnd" else dm.dense_mha_plain_bnhd
    out = plain(t(q), t(k), t(v), 0.125)
    _kernel_rule(out, ref)
    assert torch.equal(dm.dense_mha(t(q), t(k), t(v), scale=0.125, layout=layout), out)
    bf = lambda a: t(a).to(torch.bfloat16).float()
    assert torch.equal(out, plain(bf(q), bf(k), bf(v), 0.125))


# -- use_pallas=False against the JAX XLA path ----------------------------------------

def test_encoder_layer_module_path_matches_xla():
    x = RNG.normal(size=(2, T, 8, 12, C)).astype(np.float32)
    jmod = jb.EncoderLayer(dim=C, depth=2, num_heads=HEADS, num_frames=T, window_size=WIN,
                           mlp_ratio=1.0)
    v = random_variables(jmod, jnp.asarray(x), seed=4)
    mod = to_port(tb.EncoderLayer(C, 2, HEADS, T, WIN, mlp_ratio=1.0, use_pallas=False), v)
    with torch.no_grad():
        close(mod(t(x)), japply(jmod, v, x))


@pytest.fixture(scope="module")
def small_vae():
    """(JAX TDCRQVAE3, its variables, clip) at the small geometry."""
    jc, _ = small_configs()
    x = np.random.default_rng(5).uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    jm = JaxTDCRQVAE3(jc.vqvae)
    return jm, random_variables(jm, jnp.asarray(x), seed=6), x


def test_tdcrqvae3_module_path_matches_xla(small_vae):
    jm, v, x = small_vae
    _, tc = small_configs()
    mod = to_port(TDCRQVAE3(tc.vqvae, use_pallas=False), v)
    ref = japply(jm, v, x)
    with torch.no_grad():
        out, loss, codes = mod(t(x))
    close(out, ref[0])
    close(loss, ref[1])
    assert np.array_equal(codes.numpy(), np.asarray(ref[2]))


def test_stage1_plans_step():
    """One stage-I step under each plan from the same weights: the default
    trainer takes the module path (the JAX package's default trainer is held
    against it in tests/test_torch_train_stage1.py, whose port trainer passes
    use_pallas=False), --pallas the kernels' plain versions; their losses
    agree as the two forwards do."""
    _, tc = small_configs()
    vq = dataclasses.replace(tc.vqvae, restart_unused_codes=False)
    gt = torch.from_numpy(np.random.default_rng(16).integers(0, 256, (1, 3, 32, 32, 3),
                                                             dtype=np.uint8))
    metrics = {}
    for use in (False, True):
        tr = P.Stage1Trainer(vq, P.StageHyper(warmup_iter=-1), device="cpu",
                             disc=VQGANDiscriminator(**SMALL_DISC), use_pallas=use)
        assert tr.use_pallas is use
        assert all(m.use_pallas is use for m in tr.model.modules() if hasattr(m, "use_pallas"))
        state = tr.init_state(torch.Generator().manual_seed(0))
        calls = []
        orig = tb.sw_block
        tb.sw_block = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
        try:
            _, m = tr.make_step()(state, gt)
        finally:
            tb.sw_block = orig
        assert bool(calls) is use
        metrics[use] = {k: float(v) for k, v in m.items()}
    for k, ref in metrics[False].items():
        assert np.isfinite(metrics[True][k])
        assert abs(metrics[True][k] - ref) <= 2e-2 * max(abs(ref), 0.1), (k, metrics)


# -- the two plans against each other ---------------------------------------------

def test_encoder_layer_plans_agree():
    x = RNG.normal(size=(1, T, 16, 16, C)).astype(np.float32)
    jmod = jb.EncoderLayer(dim=C, depth=2, num_heads=HEADS, num_frames=T, window_size=WIN,
                           mlp_ratio=1.0)
    v = random_variables(jmod, jnp.asarray(x), seed=7)
    ref, fused = (to_port(tb.EncoderLayer(C, 2, HEADS, T, WIN, mlp_ratio=1.0, use_pallas=u), v)
                  for u in (False, True))
    calls = []
    orig = tb.sw_block
    tb.sw_block = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        with torch.no_grad():
            a, b = ref(t(x)), fused(t(x))
    finally:
        tb.sw_block = orig
    assert len(calls) == 2 and a.dtype == b.dtype == torch.float32
    d = (a - b).abs()
    assert d.max() < 0.1 and d.mean() < 0.01, (d.max(), d.mean())
    assert not torch.equal(a, b)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_transformer_layer_plans_agree(layout):
    x = RNG.normal(size=(2, 48, C)).astype(np.float32)
    pos = RNG.normal(size=(2, 48, C)).astype(np.float32)
    jmod = jt.TransformerSALayer(embed_dim=C, nhead=HEADS, dim_mlp=128)
    v = random_variables(jmod, jnp.asarray(x), jnp.asarray(pos), seed=8)
    ref, fused = (to_port(tt.TransformerSALayer(C, HEADS, 128, layout, use_pallas=u), v)
                  for u in (False, True))
    with torch.no_grad():
        a, b = ref(t(x), query_pos=t(pos)), fused(t(x), query_pos=t(pos))
    d = (a - b).abs()
    assert d.max() < 0.1 and d.mean() < 0.01, (d.max(), d.mean())
    assert not torch.equal(a, b)


def test_tdcrqvae3_plans_agree(small_vae):
    _, v, x = small_vae
    _, tc = small_configs()
    ref, fused = (to_port(TDCRQVAE3(tc.vqvae, use_pallas=u), v) for u in (False, True))
    with torch.no_grad():
        za, zb = ref.encode(t(x)), fused.encode(t(x))
    assert ((za - zb).norm() / za.norm()).item() <= 2e-2
    assert not torch.equal(za, zb)


# -- the tools and the CLIs ----------------------------------------------------------

@pytest.fixture
def small_release(monkeypatch):
    """RELEASE_PGTFORMER as the small geometry, for the tools."""
    _, tc = small_configs()
    monkeypatch.setattr(tcfg, "RELEASE_PGTFORMER", tc)
    return tc


def test_bench_train_step_on_the_cpu(small_release, tmp_path, capsys):
    from pgtformer_tpu_torch import bench_train_step
    out = tmp_path / "b.json"
    assert bench_train_step.main(["--device", "cpu", "--res", "64", "--iters", "1",
                                  "--dtype", "fp32", "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and [r["pallas"] for r in rec["runs"]] == [False, True]
    for r in rec["runs"]:
        assert set(r) == {"stage", "pallas", "dtype", "res", "batch", "iters", "step_ms",
                          "launches_per_step", "peak_bytes", "losses"}
        assert r["step_ms"] > 0 and r["launches_per_step"] == {} and r["peak_bytes"] is None
        assert r["dtype"] == "float32" and np.isfinite(r["losses"]["l_g_total"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("stage-I step (XLA towers") and "Pallas towers" in lines[1]


def test_profile_step_code_path_on_the_cpu(small_release, tmp_path):
    from pgtformer_tpu_torch import profile_step
    out = tmp_path / "p.json"
    assert profile_step.main(["--code", "--device", "cpu", "--res", "32", "--batch", "2",
                              "--steps", "1", "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"].startswith("cpu")
    for name in ("vae_forward", "vae_get_codes", "pgtformer_get_codes"):
        assert set(rec[name]) == {"wall_ms", "busy_ms", "groups_ms", "top"}
        assert rec[name]["busy_ms"] > 0
        assert set(rec[name]["groups_ms"]) <= {g for g, _ in profile_step.GROUPS} | {
            "elementwise/other"}
    assert "vq_nearest (K5)" in {g for g, _ in profile_step.GROUPS}


def test_profile_step_train_on_the_cpu(small_release, tmp_path):
    """`--train I` profiles a training step, which records its gradient
    (the serving and code paths run under inference mode)."""
    from pgtformer_tpu_torch import profile_step
    out = tmp_path / "t.json"
    assert profile_step.main(["--train", "I", "--device", "cpu", "--res", "64", "--steps", "1",
                              "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert set(rec) == {"device", "batch", "res", "plan", "wall_ms", "busy_ms", "groups_ms", "top"}
    assert rec["busy_ms"] > 0
    assert any(name.endswith("_backward") for name, _, _ in rec["top"]), rec["top"]


def test_fp32_on_cuda_fails_on_the_device_only(tmp_path):
    """--fp32 (eval_cli) and fp32 training (train_cli without --bf16) are no
    longer refused for the card; without one they fail on the device."""
    if torch.cuda.is_available():
        return
    from pgtformer_tpu_torch import eval_cli, train_cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--data-root", str(tmp_path), "--fp32", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-opt", "configs/demo_stage_I.yml", "--data-root", str(tmp_path),
                        "--device", "cuda", "--pallas"])


def test_trainer_fit_names_the_plan(small_release, tmp_path):
    """Trainer.fit's log and timings.jsonl name the plan and the dtype."""
    import logging
    from pgtformer_tpu_torch.train.trainer import Trainer
    tr = P.Stage1Trainer(small_release.vqvae, P.StageHyper(warmup_iter=-1), device="cpu",
                         disc=VQGANDiscriminator(**SMALL_DISC), use_pallas=True)
    state = tr.init_state(torch.Generator().manual_seed(0))
    gt = torch.from_numpy(np.random.default_rng(19).integers(0, 256, (1, 3, 32, 32, 3),
                                                             dtype=np.uint8))
    records = []
    logger = logging.getLogger("test_trainer_fit_names_the_plan")
    logger.addHandler(logging.Handler())
    logger.handlers[-1].emit = lambda r: records.append(r.getMessage())
    logger.setLevel(logging.INFO)
    loop = Trainer(tr, str(tmp_path), print_freq=1, use_tb_logger=False)
    loop.logger = logger
    loop.fit(state, iter([gt]), total_iter=1)
    assert records[0] == "plan: pallas: true, dtype float32"
    rec = json.loads((tmp_path / "timings.jsonl").read_text().splitlines()[-1])
    assert rec["pallas"] is True and rec["dtype"] == "float32"
