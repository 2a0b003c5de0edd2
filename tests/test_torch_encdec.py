"""The encoder-decoder family through the port against the reference:
seamless-m4t-medium reduced to 4 decoder layers and 2 encoder layers
(d_model 64, 4 heads of 16, GELU FFN), the reference's ``init_params``
weights carried across with ``params_from_jax``, audio frames made with
numpy. Prefill (the encoder over the frames, the decoder writing the
cross-attention keys and values into its cache) and 6 decode steps that
read them; the loss and every gradient with frames; microbatched train
steps; the encoder alone.

The reference runs at ``attn_impl="naive"`` (and ``"blockwise"``), not
``"pallas"``: its Pallas flash attends its own padding when not causal
(ROADMAP caveats), and 16 frames are not a multiple of its 128-row tiles.
The port's ``"flash"`` runs the kernel's plain version on the CPU, which
masks by the true length, so it computes the naive path's function. The
encoder at 128 frames, which the Pallas tiles divide, is held against the
reference's Pallas path as well.

Tolerances: logits as ``_torch_ref.LOGIT_F32_TOL`` / ``LOGIT_BF16_TOL``;
f32 losses within 1e-5 relative and gradients within 1e-4 of each leaf's
largest value, as ``tests/test_torch_train.py``.
"""
import numpy as np
import pytest
import torch

import _torch_ref
from repro_torch.configs.base import RunConfig
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import serve_loop
from repro_torch.runtime.steps import make_train_step

ARCH = "seamless-m4t-medium"
N_DECODE = 6
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


@pytest.fixture(scope="module")
def f32_pair():
    return _torch_ref.model_pair(ARCH, "float32")


def _inputs(cfg, batch, seq_len, seed, *, targets=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 255, (batch, seq_len))}
    if targets:
        out["targets"] = rng.integers(0, 255, (batch, seq_len))
    out = {k: v.astype(np.int32) for k, v in out.items()}
    out.update(_torch_ref.frontend_arrays(cfg, batch, seq_len, seed + 1))
    return out


def test_reduced_config_has_an_encoder(f32_pair):
    cfg_r, _, cfg_t, state = f32_pair
    assert cfg_t.family == "encdec" and cfg_t.encoder_layers == 2
    model = M.Transformer(cfg_t, state)
    assert len(model.encoder.layers) == 2
    assert {k for k in state if k.startswith("encoder.")} >= {
        "encoder.norm", "encoder.layers.1.attn.wqkv",
        "encoder.layers.0.ffn.wu"}
    assert "decoder.layers.3.cross.wkv" in state
    assert "ffn.wg" not in "".join(state)          # a GELU FFN, not gated


@pytest.mark.parametrize("ref_impl,port_impl",
                         [("naive", "flash"), ("blockwise", "blockwise")])
@pytest.mark.parametrize("prompt_len", [20, 64])
def test_prefill_and_decode_logits_match_reference_f32(f32_pair, prompt_len,
                                                       ref_impl, port_impl):
    """5 and 16 frames (S // 4), both ragged against any tile."""
    b = _inputs(f32_pair[2], 2, prompt_len, prompt_len)
    errs = _torch_ref.prefill_decode_errors(
        f32_pair, ref_impl, port_impl, b.pop("tokens"), N_DECODE, b)
    assert max(errs) <= _torch_ref.LOGIT_F32_TOL, errs


def test_prefill_and_decode_logits_match_reference_bf16():
    pair = _torch_ref.model_pair(ARCH, "bfloat16")
    b = _inputs(pair[2], 2, 40, 3)
    errs = _torch_ref.prefill_decode_errors(pair, "naive", "flash",
                                            b.pop("tokens"), N_DECODE, b)
    assert max(errs) <= _torch_ref.LOGIT_BF16_TOL, errs


def test_cross_attention_cache_matches_reference(f32_pair):
    """Prefill writes every layer's encoder keys and values (``xk``,
    ``xv`` [B, S_enc, nkv, hd]) next to its self-attention cache."""
    b = _inputs(f32_pair[2], 2, 48, 5)
    _, cj, _, ct = _torch_ref.prefill_both(f32_pair, "naive", "flash",
                                           b.pop("tokens"), 56, b)
    for i, layer in enumerate(ct):
        assert set(layer) == {"k", "v", "xk", "xv"}
        for key in ("xk", "xv"):
            want = np.asarray(cj["sub0"][key][i])
            assert layer[key].shape == want.shape == (2, 12, 4, 16)
            assert _torch_ref.logit_rel(layer[key].numpy(), want) <= 1e-5


@pytest.mark.parametrize("ref_impl,port_impl",
                         [("naive", "flash"), ("blockwise", "blockwise")])
def test_loss_and_grads_match_reference(f32_pair, ref_impl, port_impl):
    """``loss_fn`` with frames and the gradient of every parameter,
    encoder included, under per-layer checkpointing and the chunked
    cross-entropy (chunk 32 of 64)."""
    b = _inputs(f32_pair[2], 2, 64, 9, targets=True)
    lj, lt, errs = _torch_ref.loss_and_grads_both(f32_pair, ref_impl,
                                                  port_impl, b, xent_chunk=32)
    assert abs(lt - lj) <= LOSS_REL * abs(lj)
    assert any(k.startswith("encoder.") for k in errs)
    assert max(errs.values()) <= GRAD_REL, errs


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_steps_match_reference(f32_pair, microbatch):
    """Two ``make_train_step`` steps on batches with frames, the port
    slicing frames into microbatches as it slices tokens."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RunConfig as RefRun
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.runtime.steps import make_train_step as ref_step
    cfg_r, params, cfg_t, state = f32_pair
    kw = dict(arch=ARCH, attn_impl="blockwise", remat="none",
              microbatch=microbatch, warmup_steps=2, total_steps=10,
              lr=1e-2, grad_clip=0.5)
    step_r = jax.jit(ref_step(cfg_r, RefRun(**kw)))
    step_t = make_train_step(cfg_t, RunConfig(**dict(kw,
                                                     attn_impl="flash")))
    p_r, o_r = params, ref_adamw_init(params)
    model = M.Transformer(cfg_t, {k: v.clone() for k, v in state.items()})
    model.requires_grad_(True)
    opt = adamw_init(dict(model.named_parameters()))
    for i in range(2):
        b = _inputs(cfg_t, 4, 32, 20 + i, targets=True)
        p_r, o_r, m_r = step_r(p_r, o_r, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        m_t = step_t(model, opt, {k: torch.as_tensor(v)
                                  for k, v in b.items()})
        assert abs(float(m_t["loss"]) - float(m_r["loss"])) \
            <= LOSS_REL * abs(float(m_r["loss"]))
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_r["grad_norm"]), rel=1e-4)


@pytest.mark.parametrize("n_frames", [20, 128])
def test_encoder_matches_reference(f32_pair, n_frames):
    """The encoder alone, bidirectional: the port's flash path (masking
    by the true length) against the reference's naive path at a ragged
    frame count, and against its Pallas path at 128 frames, which its
    tiles divide."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RunConfig as RefRun
    from repro.models.transformer import run_encoder
    cfg_r, params, cfg_t, state = f32_pair
    frames = np.random.default_rng(n_frames).standard_normal(
        (2, n_frames, cfg_t.d_model)).astype(np.float32) * 0.02
    impls = ["naive"] + (["pallas"] if n_frames % 128 == 0 else [])
    got = M.encode(M.Transformer(cfg_t, state),
                   RunConfig(arch=ARCH, attn_impl="flash", remat="none"),
                   torch.as_tensor(frames))
    for impl in impls:
        run_r = RefRun(arch=ARCH, attn_impl=impl, remat="none")
        want = jax.jit(lambda p, f: run_encoder(p, cfg_r, run_r, f))(
            params, jnp.asarray(frames))
        assert _torch_ref.logit_rel(got.numpy(), want) <= 1e-5, impl


def test_make_batch_matches_the_reference_shapes(f32_pair):
    """Frames [B, S//4, d] in f32 beside tokens and targets [B, S]."""
    from repro.configs.base import ShapeConfig as RefShape
    from repro.models.model import input_specs
    from repro_torch.configs.base import ShapeConfig
    cfg_r, _, cfg_t, _ = f32_pair
    for kind in ("train", "prefill"):
        want = input_specs(cfg_r, RefShape("s", 64, 2, kind))
        got = M.make_batch(cfg_t, ShapeConfig("s", 64, 2, kind),
                           torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert got["frames"].dtype == torch.float32


def test_server_and_prefill_refuse_without_frames(f32_pair):
    """The reference's ``Server`` passes only tokens, and its prefill would
    fail on ``batch["frames"]``: the port's ``Server`` refuses an
    ``encdec`` model at construction, and a prefill without frames
    raises."""
    cfg_t, state = f32_pair[2], f32_pair[3]
    with pytest.raises(ValueError, match="encdec"):
        serve_loop.Server(cfg_t, device="cpu", params=state)
    run = RunConfig(arch=ARCH, attn_impl="flash", remat="none")
    with pytest.raises(ValueError, match="frames"):
        M.prefill(M.Transformer(cfg_t, state), run,
                  torch.zeros((1, 8), dtype=torch.long), 16)
