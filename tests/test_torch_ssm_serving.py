"""SSM serving through the port against the reference: mamba2-370m reduced
to 4 layers (d_model 64, d_state 16, head_dim 16, chunk 32), the
reference's ``init_params`` weights carried across with
``params_from_jax``. Prefill (the whole prompt through the SSD scan and
its final state) and 6 O(1) recurrent decode steps, with the reference at
``attn_impl="pallas"`` and the port at ``"flash"`` (the SSD kernel's plain
version on the CPU) and at ``"blockwise"``; the decode state after
prefill; the single-token recurrence and ``ssd_chunked`` from a state;
the two ``Server`` loops end to end.

Tolerances: logits as ``_torch_ref.LOGIT_F32_TOL`` / ``LOGIT_BF16_TOL``;
states in f32 within 1e-5 of their largest value (sum order of two scans
over <= 96 steps, measured ~1e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_ref
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.runtime import serve_loop

ARCH = "mamba2-370m"
N_DECODE = 6
STATE_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


@pytest.fixture(scope="module")
def f32_pair():
    return _torch_ref.model_pair(ARCH, "float32")


def _tokens(batch, length, seed):
    return np.random.default_rng(seed).integers(0, 255, (batch, length))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("port_impl", ["flash", "blockwise"])
@pytest.mark.parametrize("prompt_len", [32, 96])
def test_prefill_and_decode_logits_match_reference_f32(f32_pair, prompt_len,
                                                       port_impl):
    """One chunk and three chunks of prompt, then 6 recurrent steps."""
    errs = _torch_ref.prefill_decode_errors(
        f32_pair, "pallas", port_impl, _tokens(2, prompt_len, prompt_len),
        N_DECODE, {})
    assert max(errs) <= _torch_ref.LOGIT_F32_TOL, errs


def test_prefill_and_decode_logits_match_reference_bf16():
    pair = _torch_ref.model_pair(ARCH, "bfloat16")
    errs = _torch_ref.prefill_decode_errors(pair, "pallas", "flash",
                                            _tokens(2, 64, 3), N_DECODE, {})
    assert max(errs) <= _torch_ref.LOGIT_BF16_TOL, errs


def test_decode_state_after_prefill_matches_reference(f32_pair):
    """Every layer's ``conv`` (the last w-1 conv inputs, before the conv)
    and ``h`` (the scan's final state) against the reference's cache,
    whose layer g sits at index g of its one scan group's stack."""
    lj, cj, lt, ct = _torch_ref.prefill_both(
        f32_pair, "pallas", "flash", _tokens(2, 64, 4), 72, {})
    cfg_t = f32_pair[2]
    assert len(ct) == cfg_t.n_layers
    for i, layer in enumerate(ct):
        assert set(layer) == {"conv", "h"}
        for key in ("conv", "h"):
            want = np.asarray(cj["sub0"][key][i])
            assert layer[key].shape == want.shape
            assert layer[key].dtype == torch.float32
            assert _rel(layer[key].numpy(), want) <= STATE_REL, (i, key)
    assert ct[0]["h"].abs().max() > 0


def test_ssd_chunked_from_a_state_matches_reference():
    """``ssd_chunked(..., h0=...)`` against the reference's, f32: y and
    the final state, and the split identity scan(a + b) = scan(b) from
    scan(a)'s final state."""
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked as ref_chunked
    rng = np.random.default_rng(5)
    B, S, nh, hd, N, chunk = 2, 64, 4, 16, 16, 16
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, 1, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, nh, hd, N)).astype(np.float32)
    want_y, want_h = ref_chunked(*(jnp.asarray(a) for a in
                                   (x, dt, A, Bm, Cm)), chunk,
                                 h0=jnp.asarray(h0))
    t = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    y, h = ssd.ssd_chunked(*t, chunk, h0=torch.tensor(h0))
    assert _rel(y.numpy(), want_y) <= STATE_REL
    assert _rel(h.numpy(), want_h) <= STATE_REL
    y_all, h_all = ssd.ssd_chunked(*t, chunk)
    half = S // 2
    _, h_a = ssd.ssd_chunked(*(u[:, :half] if u.dim() > 1 else u
                               for u in t), chunk)
    y_b, h_b = ssd.ssd_chunked(*(u[:, half:] if u.dim() > 1 else u
                                 for u in t), chunk, h0=h_a)
    assert _rel(y_b.numpy(), y_all[:, half:].numpy()) <= STATE_REL
    assert _rel(h_b.numpy(), h_all.numpy()) <= STATE_REL


def test_ssd_decode_step_matches_reference_and_the_scan():
    """The single-token recurrence against the reference's, and S steps of
    it against the chunked scan over the same S tokens."""
    import jax.numpy as jnp
    from repro.models.ssm import ssd_decode_step as ref_step
    rng = np.random.default_rng(6)
    B, S, nh, hd, N = 2, 16, 4, 8, 16
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, 2, N)).astype(np.float32)
              for _ in range(2))
    h = rng.standard_normal((B, nh, hd, N)).astype(np.float32)
    want_y, want_h = ref_step(*(jnp.asarray(a) for a in
                                (h, x[:, 0], dt[:, 0], A, Bm[:, 0],
                                 Cm[:, 0])))
    got_y, got_h = ssm.ssd_decode_step(
        *(torch.tensor(a) for a in (h, x[:, 0], dt[:, 0], A, Bm[:, 0],
                                    Cm[:, 0])))
    assert _rel(got_y.numpy(), want_y) <= STATE_REL
    assert _rel(got_h.numpy(), want_h) <= STATE_REL
    t = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    y_scan, h_scan = ssd.ssd_chunked(*t, 8)
    state = torch.zeros(B, nh, hd, N)
    ys = []
    for i in range(S):
        y1, state = ssm.ssd_decode_step(state, t[0][:, i], t[1][:, i], t[2],
                                        t[3][:, i], t[4][:, i])
        ys.append(y1)
    assert _rel(torch.stack(ys, 1).numpy(), y_scan.numpy()) <= STATE_REL
    assert _rel(state.numpy(), h_scan.numpy()) <= STATE_REL


def test_server_completions_match_reference(f32_pair):
    """Both ``Server`` loops on the same weights and 32-token prompts (two
    epochs, one of them a partial batch): the same tokens and sites."""
    epochs = _torch_ref.serve_both(f32_pair, _tokens(3, 32, 7), batch=2,
                                   max_new=5)
    assert len(epochs) == 2
    for want, got in epochs:
        assert got == want


def test_server_refuses_a_prompt_the_chunk_does_not_divide(f32_pair):
    """The reference asserts ``S % chunk == 0`` in its scan; the port's
    ``Server`` raises ``ValueError`` before any launch and keeps the
    batch queued."""
    cfg_t, state = f32_pair[2], f32_pair[3]
    srv = serve_loop.Server(cfg_t, RunConfig(arch=ARCH, attn_impl="flash",
                                             remat="none"),
                            batch=2, s_max=64, device="cpu", params=state)
    for i, n in enumerate((32, 40)):
        prompt = torch.zeros(n, dtype=torch.long)
        srv.submit(serve_loop.Request(rid=i, prompt=prompt,
                                      max_new_tokens=2))
    with pytest.raises(ValueError, match="multiple of 32"):
        srv.step_epoch()
    assert [r.rid for r in srv.queue] == [0, 1] and not srv.completions


def test_full_forward_does_not_depend_on_the_chunk(f32_pair):
    """``chip_smoke.py`` holds cached logits against a full forward at a
    smaller chunk (2080 tokens are 65 chunks of 32, not whole chunks of
    256): the chunked scan computes the same function at any chunk."""
    cfg_t, state = f32_pair[2], f32_pair[3]
    run = RunConfig(arch=ARCH, attn_impl="naive", remat="none")
    tokens = torch.as_tensor(_tokens(2, 64, 8))
    outs = []
    for chunk in (8, 32, 64):
        cfg = dataclasses.replace(cfg_t, ssm=dataclasses.replace(
            cfg_t.ssm, chunk_size=chunk))
        outs.append(M.forward_hidden(M.Transformer(cfg, state), run, tokens))
    for o in outs[1:]:
        assert _rel(o.numpy(), outs[0].numpy()) <= STATE_REL


def test_serve_launcher_serves_a_reduced_mamba2_on_the_cpu(capsys):
    """``launch.serve`` takes the SSM and VLM archs; an SSM's prompts
    default to one scan chunk (32 tokens reduced), which it prefills."""
    from repro_torch.launch import serve as serve_launch
    assert {"mamba2-370m", "internvl2-1b", "gemma3-12b"} <= set(
        serve_launch.SERVED_ARCHS)
    assert "seamless-m4t-medium" not in serve_launch.SERVED_ARCHS
    assert serve_launch.main(["--arch", ARCH, "--requests", "2",
                              "--max-new", "2", "--device", "cpu"]) == 0
    assert "served 2 requests" in capsys.readouterr().out


def test_bf16_block_rounds_each_fused_chain_once():
    """Fault pinned (ROADMAP §3): the Mamba-2 block in bf16 rounds its
    elementwise chains (conv and SiLU; D skip, gate and gated norm) once,
    in f32 up to the next GEMM or scan. Rounding each step, as eager ops
    do, put the block 5.4e-3 relative RMS from its f32 twin (here) and
    drifted full-size mamba2's 48 layers 5.5 % of max |logit| from a
    plain full forward on the card; rounding once gives 3.7e-3, less than
    the reference's own bf16 block (6.4e-3, XLA on the CPU)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as ref_reduced
    from repro.models import init_params
    from repro.models.ssm import mamba_block as ref_block
    from repro_torch.configs import get_reduced
    kw = dict(layers=2, d_model=256, vocab=256)
    cfg_r, cfg_t = ref_reduced(ARCH, **kw), get_reduced(ARCH, **kw)
    tree = init_params(jax.random.PRNGKey(0), cfg_r)             # bf16
    p_ref = jax.tree.map(lambda a: a[0],
                         tree["decoder"]["blocks"]["sub0"]["ssm"])
    p16 = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16) for k, v in p_ref.items()}
    x = np.random.default_rng(3).standard_normal((2, 128, 256)).astype(
        np.float32)
    x16 = torch.tensor(x).to(torch.bfloat16)
    got, _ = ssm.mamba_block(p16, x16, cfg_t.ssm)
    truth, _ = ssm.mamba_block({k: v.float() for k, v in p16.items()},
                               x16.float(), cfg_t.ssm)
    ref16, _ = jax.jit(lambda p, x: ref_block(p, x, cfg_r.ssm))(
        p_ref, jnp.asarray(x).astype(jnp.bfloat16))

    def rms(a):
        a = np.asarray(a, np.float32)
        return float(np.linalg.norm(a - truth.numpy())
                     / np.linalg.norm(truth.numpy()))

    assert rms(got.float()) <= 4.5e-3
    assert rms(got.float()) < rms(ref16.astype(jnp.float32))
