"""Serving through the port against the reference: gemma3-12b reduced to 4
layers (window 16, a global layer every 2nd, 2 scan groups), the
reference's ``init_params`` weights carried across with
``params_from_jax``. Prefill + 6 decode steps with the reference at
``attn_impl="pallas"`` (interpret mode) and the port at ``"flash"`` on the
CPU, for prompts shorter than, equal to and longer than the window (the
ring roll), and the two ``Server`` loops end to end."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref
from repro.configs import get_reduced as ref_reduced
from repro.configs.base import RunConfig as RefRun
from repro.models import decode_step as ref_decode
from repro.models import init_params as ref_init
from repro.models import prefill as ref_prefill
from repro.runtime import serve_loop as ref_serve
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import serve_loop

N_DECODE = 6
# f32: sum order and XLA-vs-torch cos/pow ulps, relative to max |logit|
F32_TOL = 1e-4
# bf16: the two frameworks round activations to bf16 at different places
# (XLA fuses elementwise chains in f32, torch rounds after each op), a
# ~2^-9 relative step at each of a few dozen points in 4 layers; these
# inputs land at 3e-3 to 7e-3
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


def _pair(dtype):
    """Reference config, weights and jitted steps; the port's model on the
    same weights."""
    cfg_r = dataclasses.replace(ref_reduced("gemma3-12b", layers=4),
                                dtype=dtype)
    cfg_t = dataclasses.replace(get_reduced("gemma3-12b", layers=4),
                                dtype=dtype)
    params = ref_init(jax.random.PRNGKey(0), cfg_r)
    state = params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                            device="cpu")
    return cfg_r, params, cfg_t, state


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


def _rel(a, b) -> float:
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - b).max()
                 / np.abs(b).max())


def _prefill_and_decode(pair, prompt_len):
    """Per step (prefill, then each decode step) the relative logit error
    of the port against the reference; decode feeds the reference's
    tokens to both."""
    cfg_r, params, cfg_t, state = pair
    run_r = RefRun(arch="gemma3-12b", attn_impl="pallas", remat="none")
    run_t = RunConfig(arch="gemma3-12b", attn_impl="flash", remat="none")
    model = M.Transformer(cfg_t, state)
    s_max = prompt_len + N_DECODE + 2
    toks = np.random.default_rng(prompt_len).integers(0, 255,
                                                      (2, prompt_len))
    lj, cj = jax.jit(lambda p, b: ref_prefill(p, cfg_r, run_r, b,
                                              s_max=s_max))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, ct = M.prefill(model, run_t, torch.as_tensor(toks), s_max)
    errs = [_rel(lt.numpy(), lj)]
    dec = jax.jit(lambda p, t, c, cur: ref_decode(p, cfg_r, run_r, t, c,
                                                  cur))
    tok = np.array(jnp.argmax(lj, -1))[:, None]
    for i in range(N_DECODE):
        cur = prompt_len + i
        lj, cj = dec(params, jnp.asarray(tok, jnp.int32), cj,
                     jnp.asarray(cur, jnp.int32))
        lt, ct = M.decode_step(model, run_t, torch.as_tensor(tok), ct, cur)
        errs.append(_rel(lt.numpy(), lj))
        tok = np.array(jnp.argmax(lj, -1))[:, None]
    return errs


@pytest.mark.parametrize("prompt_len", [12, 16, 40])
def test_prefill_and_decode_logits_match_reference_f32(f32_pair, prompt_len):
    """12 < window (cache padded), 16 == window (ring, no roll), 40 > window
    and not a multiple of it (ring rolled by 40 % 16)."""
    errs = _prefill_and_decode(f32_pair, prompt_len)
    assert max(errs) <= F32_TOL, errs


def test_prefill_and_decode_logits_match_reference_bf16():
    errs = _prefill_and_decode(_pair("bfloat16"), 40)
    assert max(errs) <= BF16_TOL, errs


def test_server_completions_match_reference(f32_pair):
    """Both ``Server`` loops on the same weights and prompts (two epochs,
    one of them a partial batch): the same tokens and the same site."""
    cfg_r, params, cfg_t, state = f32_pair
    prompts = np.random.default_rng(5).integers(0, 255, (3, 20))
    ref = ref_serve.Server(cfg_r, RefRun(arch="g", attn_impl="pallas",
                                         remat="none"), batch=2, s_max=28)
    port = serve_loop.Server(cfg_t, RunConfig(arch="g", attn_impl="flash",
                                              remat="none"),
                             batch=2, s_max=28, device="cpu", params=state)
    for i, p in enumerate(prompts):
        ref.submit(ref_serve.Request(rid=i, prompt=jnp.asarray(p, jnp.int32),
                                     max_new_tokens=5))
        port.submit(serve_loop.Request(rid=i, prompt=torch.as_tensor(p),
                                       max_new_tokens=5))
    while ref.queue:
        want, got = ref.step_epoch(), port.step_epoch()
        assert [(c.rid, c.tokens, c.site) for c in got] == \
            [(c.rid, c.tokens, c.site) for c in want]
        assert all(c.emissions_mg > 0 and c.latency_s > 0 for c in got)
    assert not port.queue and len(port.completions) == 3
