"""Serving through the port against the reference: gemma3-12b reduced to 4
layers (window 16, a global layer every 2nd, 2 scan groups), the
reference's ``init_params`` weights carried across with
``params_from_jax``. Prefill + 6 decode steps with the reference at
``attn_impl="pallas"`` (interpret mode) and the port at ``"flash"`` on the
CPU, for prompts shorter than, equal to and longer than the window (the
ring roll), and the two ``Server`` loops end to end."""
import numpy as np
import pytest

import _torch_ref

ARCH = "gemma3-12b"
N_DECODE = 6


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


@pytest.fixture(scope="module")
def f32_pair():
    return _torch_ref.model_pair(ARCH, "float32")


def _prefill_and_decode(pair, prompt_len):
    """Per step (prefill, then each decode step) the relative logit error
    of the port against the reference; decode feeds the reference's
    tokens to both."""
    toks = np.random.default_rng(prompt_len).integers(0, 255,
                                                      (2, prompt_len))
    return _torch_ref.prefill_decode_errors(pair, "pallas", "flash", toks,
                                            N_DECODE, {})


@pytest.mark.parametrize("prompt_len", [12, 16, 40])
def test_prefill_and_decode_logits_match_reference_f32(f32_pair, prompt_len):
    """12 < window (cache padded), 16 == window (ring, no roll), 40 > window
    and not a multiple of it (ring rolled by 40 % 16)."""
    errs = _prefill_and_decode(f32_pair, prompt_len)
    assert max(errs) <= _torch_ref.LOGIT_F32_TOL, errs


def test_prefill_and_decode_logits_match_reference_bf16():
    errs = _prefill_and_decode(_torch_ref.model_pair(ARCH, "bfloat16"), 40)
    assert max(errs) <= _torch_ref.LOGIT_BF16_TOL, errs


def test_server_completions_match_reference(f32_pair):
    """Both ``Server`` loops on the same weights and prompts (two epochs,
    one of them a partial batch): the same tokens and the same site."""
    prompts = np.random.default_rng(5).integers(0, 255, (3, 20))
    epochs = _torch_ref.serve_both(f32_pair, prompts, batch=2, max_new=5)
    assert len(epochs) == 2
    for want, got in epochs:
        assert got == want
