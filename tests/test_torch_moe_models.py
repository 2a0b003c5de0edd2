"""The ``moe`` and ``hybrid`` families through the port against the
reference: jamba-v0.1-52b reduced to 8 layers (one period: attention at
layer 0, Mamba-2 elsewhere, MoE on even layers; 4 experts top-2),
arctic-480b to 2 layers (4 experts top-2 beside the dense residual) and
kimi-k2 to 2 layers (16 experts top-8 and a shared expert), d_model 64,
the reference's ``init_params`` weights carried across with
``params_from_jax``. Prefill and decode logits, the hybrid cache, the
``Server`` loops, ``loss_fn``'s loss, nll and aux and every gradient,
and the launcher; then the MoE logit gate of ``chip_smoke.py`` (phases
14-16): why its plain passes replay the cached path's routing, and that
it fails named MoE faults.

Tolerances: logits as ``_torch_ref.LOGIT_F32_TOL`` / ``LOGIT_BF16_TOL``;
losses and aux within 1e-5 relative and gradients within 1e-4 of each
leaf's largest value (f32 sum order, as ``tests/test_torch_train.py``).
"Drops forced" configs take capacity factor 0.5 on both sides.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_ref
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import kvcache as KC
from repro_torch.models import model as M
from repro_torch.models import moe

# arch -> get_reduced arguments (the same on both sides)
ARCHS = {"jamba-v0.1-52b": dict(layers=8),
         "arctic-480b": dict(layers=2),
         "kimi-k2-1t-a32b": dict(layers=2, n_experts=16)}
N_DECODE = 4
LOSS_REL, GRAD_REL = 1e-5, 1e-4
_PAIRS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


def pair(arch, dtype="float32", cf=None):
    """(cfg_r, params, cfg_t, state) as ``_torch_ref.model_pair``, with
    the MoE's capacity factor set to ``cf`` on both sides if given."""
    key = (arch, dtype, cf)
    if key not in _PAIRS:
        import jax
        from repro.configs import get_reduced as ref_reduced
        from repro.models import init_params
        from repro_torch.configs import get_reduced
        from repro_torch.models.convert import params_from_jax

        def cut(c):
            c = dataclasses.replace(c, dtype=dtype)
            if cf is not None:
                c = dataclasses.replace(c, moe=dataclasses.replace(
                    c.moe, capacity_factor=cf))
            return c
        cfg_r = cut(ref_reduced(arch, **ARCHS[arch]))
        cfg_t = cut(get_reduced(arch, **ARCHS[arch]))
        params = init_params(jax.random.PRNGKey(0), cfg_r)
        state = params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
        _PAIRS[key] = (cfg_r, params, cfg_t, state)
    return _PAIRS[key]


def _tokens(batch, length, seed):
    return np.random.default_rng(seed).integers(0, 255, (batch, length))


def _prompt_len(cfg):
    return 2 * cfg.ssm.chunk_size if cfg.ssm is not None else 40


@pytest.mark.parametrize("drops", [False, True],
                         ids=["cf1.25", "drops_forced"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_logits_match_reference_f32(arch, drops):
    p = pair(arch, cf=0.5 if drops else None)
    errs = _torch_ref.prefill_decode_errors(
        p, "pallas", "flash", _tokens(2, _prompt_len(p[2]), 1), N_DECODE,
        {})
    assert max(errs) <= _torch_ref.LOGIT_F32_TOL, errs


def _ref_steps(p, tokens, fed, impl):
    """The reference's jitted prefill, then a decode step for each token
    of ``fed``: every step's f32 logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RunConfig as RefRun
    from repro.models import decode_step, prefill
    cfg_r, params = p[0], p[1]
    run = RefRun(arch=cfg_r.name, attn_impl=impl, remat="none")
    P = tokens.shape[1]
    lg, cache = jax.jit(lambda q, b: prefill(q, cfg_r, run, b,
                                             s_max=P + fed.shape[1] + 1))(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    dec = jax.jit(lambda q, t, c, cur: decode_step(q, cfg_r, run, t, c, cur))
    out = [lg]
    for i in range(fed.shape[1]):
        lg, cache = dec(params, jnp.asarray(fed[:, i:i + 1], jnp.int32),
                        cache, jnp.asarray(P + i, jnp.int32))
        out.append(lg)
    return [np.asarray(o, np.float32) for o in out]


def _port_steps(p, tokens, fed):
    cfg_t, state = p[2], p[3]
    model = M.Transformer(cfg_t, state)
    run = RunConfig(arch=cfg_t.name, attn_impl="flash", remat="none")
    P = tokens.shape[1]
    lg, cache = M.prefill(model, run, torch.as_tensor(tokens),
                          P + fed.shape[1] + 1)
    out = [lg]
    for i in range(fed.shape[1]):
        lg, cache = M.decode_step(model, run, torch.as_tensor(fed[:, i:i + 1]),
                                  cache, P + i)
        out.append(lg)
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_logits_in_bf16_no_noisier_than_reference(arch):
    """bf16 against the f32 truth (the reference in f32, same weights and
    tokens): over a prefill and 4 decode steps of seeded tokens the
    port's worst step sits within ``LOGIT_BF16_TOL`` and no farther than
    the reference's own bf16 worst step. Port and reference round
    different steps to bf16 (the port's Mamba-2 chains round once, the
    reference's XLA block each step), so they sit up to the sum of the
    two noises apart (jamba: ~0.022)."""
    p16, p32 = pair(arch, "bfloat16"), pair(arch)
    tokens = _tokens(2, _prompt_len(p16[2]), 2)
    fed = _tokens(2, N_DECODE, 3)
    truth = _ref_steps(p32, tokens, fed, "pallas")
    ref16 = _ref_steps(p16, tokens, fed, "pallas")
    port16 = _port_steps(p16, tokens, fed)
    e_port = max(_torch_ref.logit_rel(a, b) for a, b in zip(port16, truth))
    e_ref = max(_torch_ref.logit_rel(a, b) for a, b in zip(ref16, truth))
    assert e_port <= _torch_ref.LOGIT_BF16_TOL, (e_port, e_ref)
    assert e_port <= e_ref, (e_port, e_ref)


def test_hybrid_layers_and_caches_follow_the_reference():
    """Full-size jamba: the interleave layer by layer (attention at 4 of
    every 8, NoPE, MoE on even layers) from the reference's
    ``block_specs``; a reduced jamba's cache after prefill: ``k``/``v``
    only on attention layers, ``conv``/``h`` only on Mamba-2 layers, each
    equal to the reference's stacked cache."""
    from repro.configs import get_config as ref_config
    from repro.models import params as rp
    cfg_t, cfg_r = get_config("jamba-v0.1-52b"), ref_config("jamba-v0.1-52b")
    ref_specs = rp.block_specs(cfg_r)
    got = KC.layer_specs(cfg_t)
    assert len(got) == 32 and cfg_t.rope_theta == 0
    for i, spec in enumerate(got):
        want = ref_specs[i % len(ref_specs)]
        assert dataclasses.asdict(spec) == dataclasses.asdict(want)
        assert spec.mixer == ("attn" if i % 8 == 4 else "ssm")
        assert spec.is_moe == (i % 2 == 0) and spec.has_ffn
    p = pair("jamba-v0.1-52b")
    lj, cj, lt, ct = _torch_ref.prefill_both(p, "pallas", "flash",
                                             _tokens(2, 64, 3), 70, {})
    cfg = p[2]
    period = len(ref_specs)
    for i, (layer, spec) in enumerate(zip(ct, KC.layer_specs(cfg))):
        sub = cj[f"sub{i % period}"]
        assert set(layer) == set(sub)
        assert set(layer) == ({"k", "v"} if spec.mixer == "attn"
                              else {"conv", "h"})
        for key, t in layer.items():
            want = np.asarray(sub[key][i // period])
            assert t.shape == want.shape and (
                str(t.dtype).split(".")[-1] == str(want.dtype))
            assert _torch_ref.logit_rel(t.numpy(), want) <= 1e-5, (i, key)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_server_completions_match_reference(arch):
    """Both ``Server`` loops on the same weights (two epochs, one a
    partial batch): the same tokens and sites."""
    p = pair(arch)
    epochs = _torch_ref.serve_both(p, _tokens(3, _prompt_len(p[2]), 7),
                                   batch=2, max_new=4)
    assert len(epochs) == 2
    for want, got in epochs:
        assert got == want


@pytest.mark.parametrize("drops", [False, True],
                         ids=["cf1.25", "drops_forced"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_aux_and_grads_match_reference(arch, drops):
    """``loss_fn`` (nll + aux_loss_weight * aux) and the gradient of every
    parameter with per-group checkpointing: the port's kernel path
    against the reference's Pallas path."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RunConfig as RefRun
    from repro.models import loss_fn as ref_loss
    from repro_torch.models.convert import params_from_jax
    cfg_r, params, cfg_t, state = pair(arch, cf=0.5 if drops else None)
    rng = np.random.default_rng(11)
    S = _prompt_len(cfg_t)
    b = {k: rng.integers(0, 256, (2, S)).astype(np.int32)
         for k in ("tokens", "targets")}
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda q: ref_loss(q, cfg_r, RefRun(arch=arch, attn_impl="pallas",
                                            remat="block"),
                           {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True))(params)
    model = M.Transformer(cfg_t, {k: v.clone() for k, v in state.items()})
    model.requires_grad_(True)
    lt, mt = M.loss_fn(model, RunConfig(arch=arch, attn_impl="flash",
                                        remat="block"),
                       {k: torch.as_tensor(v) for k, v in b.items()})
    for got, want in ((lt, lj), (mt["nll"], mj["nll"]),
                      (mt["aux"], mj["aux"])):
        assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    assert float(mt["aux"]) > 0
    assert float(lt) == pytest.approx(
        float(mt["nll"]) + cfg_t.moe.aux_loss_weight * float(mt["aux"]),
        rel=1e-6)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(lt, [q for _, q in model.named_parameters()])
    want = params_from_jax(jax.tree.map(np.asarray, gj), cfg_t, device="cpu")
    assert set(names) == set(want)
    errs = {n: float((g - want[n]).abs().max()
                     / want[n].abs().max().clamp_min(1e-30))
            for n, g in zip(names, grads)}
    assert max(errs.values()) <= GRAD_REL, errs
    assert any(".moe.router" in n for n in names)


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_step_reports_aux(microbatch):
    """``make_train_step``'s metrics carry the aux loss, with and without
    microbatching (then the mean over microbatches)."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import make_train_step
    cfg_t, state = pair("kimi-k2-1t-a32b")[2:]
    model = M.Transformer(cfg_t, {k: v.clone() for k, v in state.items()})
    model.requires_grad_(True)
    run = RunConfig(arch="k", attn_impl="flash", remat="none",
                    microbatch=microbatch)
    b = {k: torch.as_tensor(_tokens(4, 16, 5)) for k in ("tokens",
                                                         "targets")}
    want = [float(M.loss_fn(model, run, mb)[1]["aux"]) for mb in (
        [b] if not microbatch else
        [{k: v[i * 2:(i + 1) * 2] for k, v in b.items()} for i in range(2)])]
    m = make_train_step(cfg_t, run)(model, adamw_init(
        dict(model.named_parameters())), b)
    assert float(m["aux"]) == pytest.approx(float(np.mean(want)), rel=1e-6)


def test_serve_launcher_serves_reduced_moe_and_hybrid_on_the_cpu(capsys):
    """``launch.serve`` takes the three architectures; a hybrid's prompts
    default to one scan chunk (32 tokens reduced)."""
    from repro_torch.launch import serve as serve_launch
    assert {"jamba-v0.1-52b", "arctic-480b", "kimi-k2-1t-a32b"} <= set(
        serve_launch.SERVED_ARCHS)
    for arch in ("jamba-v0.1-52b", "kimi-k2-1t-a32b"):
        assert serve_launch.main(["--arch", arch, "--requests", "2",
                                  "--max-new", "2", "--device", "cpu"]) == 0
        assert "served 2 requests" in capsys.readouterr().out


def test_serve_launcher_refuses_full_weights_the_card_cannot_hold(
        monkeypatch):
    """``--full`` of a model whose bf16 weights exceed the card's free
    memory raises before any allocation, naming both byte counts."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models.params import count_params
    from repro_torch.runtime import serve_loop
    free = 79_000_000_000
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 85_000_000_000))

    def no_server(*a, **k):
        raise AssertionError("the Server was built")

    monkeypatch.setattr(serve_launch, "Server", no_server)
    need = count_params(get_config("jamba-v0.1-52b")) * 2
    with pytest.raises(MemoryError) as err:
        serve_launch.main(["--arch", "jamba-v0.1-52b", "--full"])
    assert f"{need:,}" in str(err.value) and f"{free:,}" in str(err.value)
    assert need > 100e9
    serve_launch.check_fits(get_config("mamba2-370m"), torch.device("cuda"))
    assert serve_loop.SERVED_FAMILIES[-2:] == ("moe", "hybrid")


def test_hybrid_server_refuses_a_prompt_the_chunk_does_not_divide():
    from repro_torch.runtime import serve_loop
    cfg_t, state = pair("jamba-v0.1-52b")[2:]
    srv = serve_loop.Server(cfg_t, RunConfig(arch="j", attn_impl="flash",
                                             remat="none"),
                            batch=2, s_max=64, device="cpu", params=state)
    srv.submit(serve_loop.Request(rid=0, prompt=torch.zeros(40,
                                                            dtype=torch.long),
                                  max_new_tokens=2))
    with pytest.raises(ValueError, match="multiple of 32"):
        srv.step_epoch()
    assert [r.rid for r in srv.queue] == [0]


# --- the MoE logit gate (chip_smoke.py phases 14-16) -------------------------

def _ref_cached_and_full(p, tokens, fed):
    """The reference's cached logits (prefill, then a decode step for each
    token of ``fed``) and its full forward's logits at the same
    positions."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RunConfig as RefRun
    from repro.models import decode_step, prefill
    from repro.models.model import embed, unembed
    from repro.models.transformer import run_decoder
    cfg_r, params = p[0], p[1]
    run = RefRun(arch="r", attn_impl="naive", remat="none")
    P = tokens.shape[1]
    lg, cache = prefill(params, cfg_r, run,
                        {"tokens": jnp.asarray(tokens, jnp.int32)},
                        s_max=P + fed.shape[1] + 1)
    out = [lg]
    for i in range(fed.shape[1]):
        lg, cache = decode_step(params, cfg_r, run,
                                jnp.asarray(fed[:, i:i + 1], jnp.int32),
                                cache, jnp.asarray(P + i, jnp.int32))
        out.append(lg)
    seq = jnp.asarray(np.concatenate([tokens, fed], 1), jnp.int32)
    x, _, _ = run_decoder(params, cfg_r, run, embed(params, cfg_r, seq),
                          mode="train")
    full = unembed(params, cfg_r, x[:, P - 1:P - 1 + len(out)])
    return np.stack([np.asarray(o) for o in out], 1), np.asarray(
        full.astype(jnp.float32))


@pytest.fixture
def cpu_smoke(monkeypatch):
    """``chip_smoke`` on the CPU: the device, a short cache, no CUDA
    synchronisation."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "S_MAX", 100)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return chip_smoke


def _gate_inputs(cfg, n_fed):
    tokens = torch.as_tensor(_tokens(2, _prompt_len(cfg), 21))
    fed = torch.as_tensor(_tokens(2, n_fed, 22))
    return tokens, fed


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_reference_cached_path_drops_unlike_its_full_forward(arch,
                                                             cpu_smoke):
    """With drops forced, the reference's own cached decode sits far from
    its full forward over the same tokens: the full forward's dispatch
    (all 2 x (P + n) tokens at once) ranks and drops other assignments
    than the prefill's and the decode steps'. The port does the same.
    The gate's plain passes, routing in the cached path's groups,
    reproduce the cached logits to f32 noise."""
    p = pair(arch, cf=0.5)
    cfg_t, state = p[2], p[3]
    n_fed = cfg_t.ssm.chunk_size if cfg_t.ssm is not None else 5
    tokens, fed = _gate_inputs(cfg_t, n_fed)
    r_cached, r_full = _ref_cached_and_full(p, tokens.numpy(), fed.numpy())
    model = M.Transformer(cfg_t, state)
    run = RunConfig(arch=arch, attn_impl="naive", remat="none")
    t_cached = torch.stack(cpu_smoke.cached_steps(M, model, run, tokens,
                                                  fed)[0], 1)
    P = tokens.shape[1]
    h = M.forward_hidden(model, run, torch.cat([tokens, fed], 1))
    t_full = M.unembed(model, h[:, P - 1:P + n_fed]).float()
    ref_gap = _torch_ref.logit_rel(r_cached, r_full)
    assert ref_gap > 10 * _torch_ref.LOGIT_F32_TOL
    assert _torch_ref.logit_rel(t_cached.numpy(), r_cached) \
        <= _torch_ref.LOGIT_F32_TOL
    assert _torch_ref.logit_rel(t_full.numpy(), r_full) \
        <= _torch_ref.LOGIT_F32_TOL
    res = cpu_smoke.moe_logit_gate(M, model, run, tokens, fed)
    assert res["cached_vs_full_rel"] <= _torch_ref.LOGIT_F32_TOL
    assert res["flash_vs_naive_prefill_rel"] <= _torch_ref.LOGIT_F32_TOL
    assert sum(res["prefill_drops_by_layer"]) > 0
    assert res["keep_mismatch"] == res["cap_mismatch"] == 0


def _unstable_dispatch(real):
    """Ranks within an expert in reverse flat order."""
    def dispatch(top_i, n_experts, cap):
        A = top_i.numel()
        e_flat = top_i.reshape(A)
        order = torch.argsort(e_flat * A + (A - 1 - torch.arange(A)),
                              stable=True)
        counts = torch.bincount(e_flat, minlength=n_experts)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty(A, dtype=torch.int64)
        rank[order] = torch.arange(A) - starts[e_flat[order]]
        return e_flat, torch.clamp(rank, max=cap - 1), rank < cap
    return dispatch


# fault -> (the moe function it replaces, its maker, the gate's check that
# must catch it)
FAULTS = {
    "unstable_sort": ("dispatch_indices", _unstable_dispatch,
                      lambda r: r["layer_keep_mismatch"] > 0),
    "combine_ignores_keep": ("combine", lambda real: (
        lambda out, e, slot, top_p, keep, k:
        real(out, e, slot, top_p, torch.ones_like(keep), k)),
        lambda r: r["layer_err"] > r["layer_tol"]),
    "capacity_off_by_8": ("capacity", lambda real: (
        lambda n, cfg: real(n, cfg) + 8),
        lambda r: r["layer_cap_mismatch"] > 0),
}


@pytest.mark.parametrize("case", ["clean", "bf16_hidden_once"]
                         + list(FAULTS))
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_moe_gate_fails_named_faults(arch, case, cpu_smoke, monkeypatch,
                                    capsys):
    """``chip_smoke.moe_logit_gate`` on reduced f32 models with drops
    forced: the clean kernel path (the plain versions on the CPU) passes,
    and so does the plain path against itself with its hidden state
    rounded once to bf16 (its top-k choices flip at near ties, which the
    replay absorbs); an unstable sort, a combine that ignores the drops
    and a capacity off by 8 in the cached path each fail it."""
    p = pair(arch, cf=0.5)
    cfg_t, state = p[2], p[3]
    tokens, fed = _gate_inputs(cfg_t, cfg_t.ssm.chunk_size
                               if cfg_t.ssm is not None else 5)
    model = M.Transformer(cfg_t, state)
    run = RunConfig(arch=arch, attn_impl="flash", remat="none")
    if case in FAULTS:
        name, make, caught = FAULTS[case]
        monkeypatch.setattr(moe, name, make(getattr(moe, name)))
        with pytest.raises(RuntimeError, match="failed"):
            cpu_smoke.moe_logit_gate(M, model, run, tokens, fed)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert caught(res["moe_logit_check"]), res
        return
    if case == "bf16_hidden_once":
        real_steps, real_embed = cpu_smoke.cached_steps, M.embed

        def rounded_steps(*a, **k):
            with monkeypatch.context() as m:
                m.setattr(M, "embed", lambda *e, **ek: real_embed(
                    *e, **ek).bfloat16().float())
                return real_steps(*a, **k)

        monkeypatch.setattr(cpu_smoke, "cached_steps", rounded_steps)
        run = dataclasses.replace(run, attn_impl="naive")
    res = cpu_smoke.moe_logit_gate(M, model, run, tokens, fed)
    assert sum(res["prefill_drops_by_layer"]) > 0
    if case == "bf16_hidden_once":
        assert res["cached_vs_full_rel"] > 0
