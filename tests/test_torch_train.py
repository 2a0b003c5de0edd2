"""Training through the port against the reference: mamba2-370m reduced to
2 layers (d_model 64, d_state 16, head_dim 16, chunk 32, vocab 256) in
f32, the reference's ``init_params`` weights carried across with
``params_from_jax``. The loss and every gradient, train steps with and
without microbatching, the token pipeline, the ``Trainer`` with injected
faults, the checkpoint round trip, the optimizer's cross-pod sync, and
the device rules of the training entry points.

Tolerances (f32): losses within 1e-5 relative and gradients within 1e-4
of each leaf's largest value cover f32 sum-order differences between XLA
and torch (measured ~2e-6). After 3 AdamW steps at lr 1e-2 every weight
sits within 1e-3 of the reference's and 99 % within 1e-5: Adam's
normalised update moves a weight by ~lr whatever its gradient's size, so
where a gradient is near zero its f32 noise moves the weight by a visible
fraction of lr (measured: at most 2.4e-4, on 0.3 % of the weights).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import _torch_ref
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import compression, localsgd
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

ARCH = "mamba2-370m"
SMALL = dict(layers=2, d_model=64, vocab=256)
LOSS_REL, GRAD_REL = 1e-5, 1e-4
PARAM_ABS, PARAM_CLOSE, PARAM_CLOSE_SHARE = 1e-3, 1e-5, 0.99


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


@pytest.fixture(scope="module")
def pair():
    """Reference config and weights (f32); the port's config and the same
    weights as a state dict."""
    import jax
    from repro.configs import get_reduced as ref_reduced
    from repro.models import init_params
    cfg_r = dataclasses.replace(ref_reduced(ARCH, **SMALL), dtype="float32")
    cfg_t = dataclasses.replace(get_reduced(ARCH, **SMALL), dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg_r)
    state = params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                            device="cpu")
    return cfg_r, params, cfg_t, state


def _batch(seed, B=2, S=64):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (B, S)).astype(np.int32)
            for k in ("tokens", "targets")}


def _model(cfg_t, state):
    model = M.Transformer(cfg_t, {k: v.clone() for k, v in state.items()})
    return model.requires_grad_(True)


def _leaf_errors(got, want_tree, cfg_t):
    """max |got - want| / max |want| per state-dict leaf."""
    import jax
    want = params_from_jax(jax.tree.map(np.asarray, want_tree), cfg_t,
                           device="cpu")
    assert set(got) == set(want)
    return {k: float((got[k].detach().float() - want[k].float()).abs().max()
                     / want[k].float().abs().max().clamp_min(1e-30))
            for k in want}


@pytest.mark.parametrize("impl", ["flash", "blockwise"])
def test_loss_and_grads_match_reference(pair, impl):
    """``loss_fn`` and the gradient of every parameter, with per-layer
    checkpointing and the chunked cross-entropy (chunk 32 of 64): the
    port's kernel path against the reference's Pallas path, its chunked
    path against the reference's jnp path."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RunConfig as RefRun
    from repro.models import loss_fn as ref_loss
    cfg_r, params, cfg_t, state = pair
    ref_impl = "pallas" if impl == "flash" else impl
    b = _batch(1, B=1)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: ref_loss(p, cfg_r, RefRun(arch=ARCH, attn_impl=ref_impl,
                                            remat="block"),
                           {k: jnp.asarray(v) for k, v in b.items()},
                           xent_chunk=32), has_aux=True))(params)
    model = _model(cfg_t, state)
    lt, aux = M.loss_fn(model, RunConfig(arch=ARCH, attn_impl=impl,
                                         remat="block"),
                        {k: torch.as_tensor(v) for k, v in b.items()},
                        xent_chunk=32)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(lt, [p for _, p in model.named_parameters()])
    assert abs(float(lt) - float(lj)) <= LOSS_REL * abs(float(lj))
    assert float(aux["nll"]) == float(lt)
    errs = _leaf_errors(dict(zip(names, grads)), gj, cfg_t)
    assert max(errs.values()) <= GRAD_REL, errs


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_steps_match_reference(pair, microbatch):
    """Three ``make_train_step`` steps (AdamW, warmup, clipping, decay on
    the reference's leaves) from the same weights and batches."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RunConfig as RefRun
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.runtime.steps import make_train_step as ref_step
    cfg_r, params, cfg_t, state = pair
    kw = dict(arch=ARCH, attn_impl="blockwise", remat="none",
              microbatch=microbatch, warmup_steps=2, total_steps=10,
              lr=1e-2, grad_clip=0.5)
    step_r = jax.jit(ref_step(cfg_r, RefRun(**kw)))
    step_t = make_train_step(cfg_t, RunConfig(**kw))
    p_r, o_r = params, ref_adamw_init(params)
    model = _model(cfg_t, state)
    opt = adamw_init(dict(model.named_parameters()))
    for i in range(3):
        b = _batch(10 + i, B=4, S=32)
        p_r, o_r, m_r = step_r(p_r, o_r, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        m_t = step_t(model, opt, {k: torch.as_tensor(v)
                                  for k, v in b.items()})
        assert abs(float(m_t["loss"]) - float(m_r["loss"])) \
            <= LOSS_REL * abs(float(m_r["loss"]))
        assert m_t["lr"] == pytest.approx(float(m_r["lr"]), rel=1e-6)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_r["grad_norm"]), rel=1e-4)
    assert opt.step == int(o_r.step) == 3
    want = params_from_jax(jax.tree.map(np.asarray, p_r), cfg_t,
                           device="cpu")
    diff = torch.cat([(p.detach() - want[k]).abs().reshape(-1)
                      for k, p in model.named_parameters()])
    assert float(diff.max()) <= PARAM_ABS
    assert float((diff <= PARAM_CLOSE).float().mean()) >= PARAM_CLOSE_SHARE


def test_token_pipeline_batches_are_bit_equal_to_the_reference():
    from repro.data.pipeline import TokenPipeline as RefPipeline
    kw = dict(vocab_size=1000, seq_len=33, batch=3, seed=5,
              steps_per_shard=2)
    ref, port = RefPipeline(**kw), TokenPipeline(**kw)
    for i in range(5):
        want, got = ref.next_batch(float(i)), port.next_batch(float(i))
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert port.snapshot() == ref.snapshot()


def test_trainer_matches_reference_with_faults(pair, tmp_path):
    """Both ``Trainer`` loops on the same weights, at the reference's fleet
    figures (300 W a chip) and a brutal fault rate: the same events
    (faults, restores, stragglers, mirrors, migrations), sites, CI and
    emissions, and the same losses."""
    import jax
    from repro.configs.base import RunConfig as RefRun
    from repro.runtime.steps import make_train_step as make_ref_step
    from repro.runtime.train_loop import Trainer as RefTrainer
    from repro.runtime.train_loop import TrainLoopConfig as RefLoop
    cfg_r, _, cfg_t, _ = pair
    run = dict(arch=ARCH, attn_impl="blockwise", remat="block",
               warmup_steps=2, total_steps=24, seed=3)
    loop = dict(total_steps=24, ckpt_every=4, log_every=2,
                inject_faults=True, chip_power_w=300.0, site="site_ne")
    ref = RefTrainer(cfg_r, RefRun(**run),
                     RefLoop(ckpt_dir=str(tmp_path / "ref"), **loop),
                     batch_override=2, seq_override=64)
    port = Trainer(cfg_t, RunConfig(**dict(run, attn_impl="flash")),
                   TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **loop),
                   batch_override=2, seq_override=64, device="cpu",
                   params=params_from_jax(jax.tree.map(np.asarray,
                                                       ref.params),
                                          cfg_t, device="cpu"))
    # the reference's jit donates params and optimizer state, and in f32
    # its master copy aliases the params (astype is a no-op), which XLA
    # refuses: run the reference's own step jitted without donation
    ref._step_fn = jax.jit(make_ref_step(cfg_r, RefRun(**run)))
    for tr in (ref, port):
        tr.faults.mtbf_node_s = 3e4
    want, got = ref.run_steps(), port.run_steps()
    assert any(e.startswith("fault:") for e in want["events"])
    assert got["events"] == want["events"]
    assert got["final_step"] == want["final_step"] == 24
    assert got["data_fetches"] == want["data_fetches"]
    for k in ("energy_kwh", "emissions_g", "dcn_gb"):
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0)
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert (g["step"], g["site"]) == (w["step"], w["site"])
        assert g["ci"] == pytest.approx(w["ci"], rel=1e-9, abs=0)
        assert g["emissions_g"] == pytest.approx(w["emissions_g"], rel=1e-9,
                                                 abs=0)
        assert g["loss"] == pytest.approx(w["loss"], rel=LOSS_REL)


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    """bf16 parameters and f32 optimizer state come back bit for bit, in
    the reference's layout (step dirs, arrays.npz + meta.json, LATEST, the
    last ``keep`` kept), with a mirror job sized like the reference's."""
    cfg = get_reduced(ARCH, **SMALL)
    model = M.build_model(cfg, seed=3, device="cpu")
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    opt.step = 7
    for t in opt.m.values():
        t.normal_(generator=torch.Generator().manual_seed(1))
    mgr = ckpt.CheckpointManager(str(tmp_path), interval_steps=1, keep=2,
                                 mirror_replicas=("site_ne",))
    for s in (1, 2, 3):
        mgr.save(s, params, opt, extra={"pipeline": {"shard_cursor": s,
                                                     "step_in_shard": 0}})
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002",
                                            "step_00000003"]
    assert (tmp_path / "LATEST").read_text() == "step_00000003"
    meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
    assert meta["step"] == 3 and meta["n_arrays"] == 1 + 4 * len(params)
    tmpl_p = {k: torch.zeros_like(v) for k, v in params.items()}
    step, p2, o2, extra = mgr.restore_latest(tmpl_p, adamw_init(tmpl_p))
    assert (step, o2.step, extra["pipeline"]["shard_cursor"]) == (3, 7, 3)
    assert {v.dtype for v in params.values()} == {torch.bfloat16,
                                                  torch.float32}
    for k, v in params.items():
        assert p2[k].dtype == v.dtype
        assert torch.equal(p2[k].view(torch.int16), v.view(torch.int16))
        for tree in ("master", "m", "v"):
            assert torch.equal(getattr(o2, tree)[k], getattr(opt, tree)[k])
    n_bytes = sum(v.numel() * v.element_size() for v in params.values()) \
        + 4 + 3 * sum(v.numel() * 4 for v in params.values())
    assert [j.size_bytes for j in mgr.pending_mirrors] == [n_bytes] * 3


def test_trainer_restarts_from_its_checkpoint(tmp_path):
    cfg = get_reduced(ARCH, **SMALL)
    run = RunConfig(arch=ARCH, attn_impl="flash", remat="block")
    loop = TrainLoopConfig(total_steps=4, ckpt_every=2, log_every=2,
                           ckpt_dir=str(tmp_path))
    t1 = Trainer(cfg, run, loop, batch_override=2, seq_override=64,
                 device="cpu")
    out = t1.run_steps()
    assert out["final_step"] == 4 and np.isfinite(out["final_loss"])
    t2 = Trainer(cfg, run, loop, batch_override=2, seq_override=64,
                 device="cpu")
    assert t2.start_step == 4 and t2.events == ["restored@4"]
    assert t2.pipeline.snapshot() == t1.pipeline.snapshot()
    assert t2.opt.step == t1.opt.step == 4
    for k, v in t1.params.items():
        assert torch.equal(t2.params[k], v)


@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
def test_pod_sync_matches_reference(scheme):
    """Two pods' deltas through the compressed cross-pod sync."""
    import jax.numpy as jnp
    from repro.optim import localsgd as ref_lsgd
    from repro.optim.compression import init_compression_state
    rng = np.random.default_rng(4)
    base = {"a": rng.standard_normal((8, 16)), "b": rng.standard_normal(32)}
    pods = [{k: v + 0.1 * rng.standard_normal(v.shape)
             for k, v in base.items()} for _ in range(2)]
    f32 = lambda d, mk: {k: mk(np.asarray(v, np.float32))
                         for k, v in d.items()}
    outer_r = ref_lsgd.outer_init(f32(base, jnp.asarray))
    outer_t = localsgd.outer_init(f32(base, torch.tensor))
    if scheme == "topk":
        outer_r = dataclasses.replace(outer_r, compression=(
            init_compression_state(outer_r.anchor)))
        outer_t.compression = compression.init_compression_state(
            outer_t.anchor)
    new_r, o_r, wire_r = ref_lsgd.pod_sync(
        [f32(p, jnp.asarray) for p in pods], outer_r, scheme=scheme,
        k_frac=0.25)
    new_t, o_t, wire_t = localsgd.pod_sync(
        [f32(p, torch.tensor) for p in pods], outer_t, scheme=scheme,
        k_frac=0.25)
    assert wire_t == wire_r
    for k in base:
        np.testing.assert_allclose(o_t.anchor[k].numpy(),
                                   np.asarray(o_r.anchor[k]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(new_t[1][k].numpy(),
                                   np.asarray(new_r[1][k]), rtol=0,
                                   atol=1e-6)
    assert localsgd.CarbonSyncController().period(400.0) == \
        ref_lsgd.CarbonSyncController().period(400.0)


def test_without_cuda_training_raises_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced(ARCH, **SMALL)
    run = RunConfig(arch=ARCH, attn_impl="flash")
    loop = TrainLoopConfig(ckpt_dir=str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, run, loop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, run, loop, device="cuda")
    args = ["--steps", "2", "--seq", "32", "--batch", "2", "--ckpt-every", "1",
            "--ckpt-dir",
            str(tmp_path / "launch")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(args)
    with pytest.raises(ValueError, match="attn_impl"):
        Trainer(cfg, RunConfig(arch=ARCH, attn_impl="pallas"), loop,
                device="cpu")
    assert train_launch.main(args + ["--device", "cpu"]) == 0
    assert (tmp_path / "launch" / "LATEST").exists()
