"""The vision-language family through the port against the reference:
internvl2-1b reduced to 4 layers (d_model 64, 4 query heads over 1 kv
head of 16, qkv bias, tied embeddings, 4 patch positions), the
reference's ``init_params`` weights carried across with
``params_from_jax``, patch embeddings made with numpy. Prefill with the
patches prepended to the text and 6 decode steps after them, with the
reference at ``attn_impl="pallas"`` (interpret mode) and the port at
``"flash"`` on the CPU; the loss (text positions only) and every gradient;
the two ``Server`` loops, which serve text only.

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

ARCH = "internvl2-1b"
N_DECODE = 6
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


@pytest.fixture(scope="module")
def f32_pair():
    return _torch_ref.model_pair(ARCH, "float32")


def _inputs(cfg, batch, text_len, seed, *, targets=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 255, (batch, text_len))}
    if targets:
        out["targets"] = rng.integers(0, 255, (batch, text_len))
    out = {k: v.astype(np.int32) for k, v in out.items()}
    out.update(_torch_ref.frontend_arrays(cfg, batch, text_len, seed + 1))
    return out


@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text_only"])
@pytest.mark.parametrize("text_len", [12, 60])
def test_prefill_and_decode_logits_match_reference_f32(f32_pair, text_len,
                                                       with_patches):
    b = _inputs(f32_pair[2], 2, text_len, text_len)
    if not with_patches:
        del b["patches"]
    errs = _torch_ref.prefill_decode_errors(
        f32_pair, "pallas", "flash", b.pop("tokens"), N_DECODE, b)
    assert max(errs) <= _torch_ref.LOGIT_F32_TOL, errs


def test_prefill_and_decode_logits_match_reference_bf16():
    pair = _torch_ref.model_pair(ARCH, "bfloat16")
    b = _inputs(pair[2], 2, 36, 3)
    errs = _torch_ref.prefill_decode_errors(pair, "pallas", "flash",
                                            b.pop("tokens"), N_DECODE, b)
    assert max(errs) <= _torch_ref.LOGIT_BF16_TOL, errs


def test_patches_are_prepended_then_scaled(f32_pair):
    """``embed`` puts the patches before the text and scales both by
    sqrt(d_model), as the reference's does."""
    import jax.numpy as jnp
    from repro.models.model import embed as ref_embed
    cfg_r, params, cfg_t, state = f32_pair
    b = _inputs(cfg_t, 2, 8, 4)
    want = ref_embed(params, cfg_r, jnp.asarray(b["tokens"]),
                     jnp.asarray(b["patches"]))
    got = M.embed(M.Transformer(cfg_t, state), torch.as_tensor(b["tokens"]),
                  torch.as_tensor(b["patches"]))
    assert got.shape == (2, 4 + 8, cfg_t.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("ref_impl,port_impl",
                         [("pallas", "flash"), ("blockwise", "blockwise")])
def test_loss_and_grads_match_reference(f32_pair, ref_impl, port_impl):
    """``loss_fn`` with patches (only the text positions scored) and the
    gradient of every parameter, under per-layer checkpointing."""
    b = _inputs(f32_pair[2], 2, 60, 9, targets=True)
    lj, lt, errs = _torch_ref.loss_and_grads_both(f32_pair, ref_impl,
                                                  port_impl, b)
    assert abs(lt - lj) <= LOSS_REL * abs(lj)
    assert max(errs.values()) <= GRAD_REL, errs


def test_server_completions_match_reference(f32_pair):
    """Both ``Server`` loops serve text-only prompts (the reference's
    passes only ``{"tokens"}``): the same tokens and sites over two
    epochs, one of them a partial batch."""
    prompts = np.random.default_rng(5).integers(0, 255, (3, 20))
    epochs = _torch_ref.serve_both(f32_pair, prompts, batch=2, max_new=5)
    assert len(epochs) == 2
    for want, got in epochs:
        assert got == want


def test_make_batch_matches_the_reference_shapes(f32_pair):
    """Patches [B, P, d] in f32 beside tokens and targets over the text
    length S - P."""
    from repro.configs.base import ShapeConfig as RefShape
    from repro.models.model import input_specs
    from repro_torch.configs.base import ShapeConfig
    cfg_r, _, cfg_t, _ = f32_pair
    assert M.text_len(cfg_t, 64) == 60
    for kind in ("train", "prefill"):
        want = input_specs(cfg_r, RefShape("s", 64, 2, kind))
        got = M.make_batch(cfg_t, ShapeConfig("s", 64, 2, kind),
                           torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert got["patches"].dtype == torch.float32
