"""The port's expert-parallel MoE (``repro_torch/models/moe.py``
``expert_parallel``: ``moe_ffn`` under a ``HostMesh``) against the
reference's ``shard_map`` branch (``_routed_shardmap``), which runs in a
child process on 4 forced host devices, on the CPU.

Meshes 2 x 2, 1 x 4 and 4 x 1, and 2 x 1 with an odd token count (the
tokens do not split: every data rank routes them all); gated and ungated
experts, shared experts, the dense residual; a capacity factor at which
the token shards drop assignments the global dispatch keeps. y, aux and
the gradients (``jax.grad`` of the reference's sharded path against
autograd through the port's loops) within 1e-5 of each one's largest
value in f32: the sum orders differ, the choices and drops do not.

Then ``chip_smoke.py``'s gate of the branch on the card
(``moe_ep_check``): it passes the branch, in f32 and bf16, and fails each
of four faults put into a copy of the branch's source.
"""
import dataclasses
import inspect
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

import _torch_ref as ref
from repro_torch.configs import get_reduced
from repro_torch.configs.base import MoEConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.runtime import pspec as PS

REL = 1e-5
CASES = {c[0]: c for c in ref.MOE_EP_CASES}


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref.run_reference("moe_ep", tmp_path_factory.mktemp("ref")
                             / "moe_ep.npz", host_devices=ref.MOE_EP_DEVICES)


def _cfg(case):
    _, _, _, _, _, n_shared, dense, cf = case
    return MoEConfig(n_experts=ref.MOE_EP_EXPERTS, top_k=ref.MOE_EP_TOP_K,
                     d_ff_expert=ref.MOE_EP_F, n_shared_experts=n_shared,
                     dense_residual=dense, capacity_factor=cf)


def _mesh(shape):
    return PS.HostMesh(np.full(shape, "cpu", dtype=object),
                       ("data", "model"))


def _inputs(case, dtype=torch.float32):
    arrs = {k: torch.as_tensor(v).to(dtype)
            for k, v in ref.moe_ep_inputs(case).items()}
    return arrs.pop("x"), arrs.pop("cot"), arrs


def _run(case, mesh):
    """The port's moe_ffn under ``mesh`` (None: unmeshed) -> y, aux and
    the gradient of sum(y * cot) + MOE_EP_AUX_W * aux for each weight and
    for x."""
    x, cot, p = _inputs(case)
    for t in (x, *p.values()):
        t.requires_grad_(True)
    with PS.sharding_scope(mesh, "2d"):
        y, aux = moe.moe_ffn(p, x, _cfg(case), gated=case[4])
    loss = (y * cot).sum() + ref.MOE_EP_AUX_W * aux
    grads = torch.autograd.grad(loss, [x, *p.values()])
    return y.detach(), aux.detach(), dict(zip(["x", *p], grads))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_expert_parallel_matches_reference_sharded_path(reference, name):
    case = CASES[name]
    y, aux, grads = _run(case, _mesh(case[1]))
    assert _rel(y, reference[f"{name}/y"]) <= REL
    assert _rel(aux, reference[f"{name}/aux"]) <= REL
    want = {k.split("/")[-1] for k in reference
            if k.startswith(f"{name}/grad/")}
    assert set(grads) == want
    for k, g in grads.items():
        assert _rel(g, reference[f"{name}/grad/{k}"]) <= REL, k


@pytest.mark.parametrize("name", ["2x2_drops", "4x1_ungated_dense"])
def test_token_shards_drop_what_the_global_dispatch_keeps(reference, name):
    """Each token shard dispatches at its own, smaller capacity: it drops
    assignments that the single-device layer keeps, so the two outputs
    and aux differ far past the tolerance."""
    case = CASES[name]
    drops = {}
    real = moe.dispatch_indices
    for key, mesh in (("mesh", _mesh(case[1])), ("global", None)):
        seen = []

        def dispatch(top_i, n_experts, cap, _seen=seen):
            out = real(top_i, n_experts, cap)
            _seen.append((cap, out[2]))
            return out

        moe.dispatch_indices = dispatch
        try:
            y, aux, _ = _run(case, mesh)
        finally:
            moe.dispatch_indices = real
        drops[key] = (seen, y, aux)
    (m_seen, m_y, m_aux), (g_seen, g_y, g_aux) = drops["mesh"], \
        drops["global"]
    assert len(m_seen) == case[1][0] and len(g_seen) == 1
    assert all(cap < g_seen[0][0] for cap, _ in m_seen)
    m_keep = torch.cat([keep for _, keep in m_seen])
    assert (m_keep != g_seen[0][1]).sum() > 0 and (~m_keep).sum() > 0
    assert _rel(g_y, reference[f"{name}/y"]) > 100 * REL
    assert _rel(g_aux, reference[f"{name}/aux"]) > 100 * REL
    assert _rel(m_y, reference[f"{name}/y"]) <= REL


def test_one_token_shard_is_the_single_device_layer():
    """Tokens that do not split (T odd over 2 data ranks), or one data
    rank: one dispatch at the global capacity, so the branch is the
    single-device layer up to the model ranks' sum order."""
    for name in ("2x1_odd_tokens_shared_dense", "1x4_shared"):
        case = CASES[name]
        y, aux, _ = _run(case, _mesh(case[1]))
        y0, aux0, _ = _run(case, None)
        assert _rel(y, y0) <= REL and _rel(aux, aux0) <= REL


def test_ranks_write_nothing_shared_on_a_repeated_device():
    """On one device every rank's weights are views of the same tensors
    and the moves are no-ops: a forward and backward leaves the weights
    and the input as they were."""
    case = CASES["2x2_drops"]
    x, cot, p = _inputs(case)
    before = {k: v.clone() for k, v in p.items()}, x.clone()
    for t in (x, *p.values()):
        t.requires_grad_(True)
    with PS.sharding_scope(_mesh((2, 2)), "2d"):
        y, aux = moe.moe_ffn(p, x, _cfg(case))
    ((y * cot).sum() + aux).backward()
    assert all(torch.equal(p[k].detach(), v) for k, v in before[0].items())
    assert torch.equal(x.detach(), before[1])


def test_shape_only_mesh_and_uneven_experts_are_refused():
    case = CASES["2x2_drops"]
    x, _, p = _inputs(case)
    with PS.sharding_scope(PS.abstract_mesh((2, 2), ("data", "model"))):
        with pytest.raises(TypeError, match="places nothing"):
            moe.moe_ffn(p, x, _cfg(case))
    with PS.sharding_scope(_mesh((1, 3)), "2d"):
        with pytest.raises(ValueError, match="8 experts do not split"):
            moe.moe_ffn(p, x, _cfg(case))


def test_dp_rules_split_tokens_over_every_axis():
    """Under the dp rules the batch takes both mesh axes and no axis holds
    experts: four token shards, each with all experts."""
    case = CASES["2x2_drops"]
    x, _, p = _inputs(case)
    seen = []
    real = moe.dispatch_indices

    def dispatch(top_i, n_experts, cap):
        seen.append(top_i.shape[0])
        return real(top_i, n_experts, cap)

    moe.dispatch_indices = dispatch
    try:
        with PS.sharding_scope(_mesh((2, 2)), "dp"):
            moe.moe_ffn(p, x, _cfg(case))
    finally:
        moe.dispatch_indices = real
    assert seen == [x.shape[0] * x.shape[1] // 4] * 4


def test_train_step_recompute_keeps_the_mesh_on_another_thread():
    """With remat the decoder's checkpoint recomputes each group in the
    backward, which autograd runs on a device thread on the card; the
    recompute re-enters the forward's scope, so it takes the branch too,
    and the step's loss and gradients are the unmeshed ones to f32 noise
    on a 1 x 2 mesh."""
    cfg = dataclasses.replace(get_reduced("kimi-k2-1t-a32b", layers=1),
                              dtype="float32")
    run = RunConfig(arch="k", attn_impl="naive", remat="block")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    model = M.build_model(cfg, seed=0, device="cpu").requires_grad_(True)
    names, params = zip(*model.named_parameters())
    out = {}
    for key, mesh in (("global", None), ("mesh", _mesh((1, 2)))):
        calls = []
        real = moe.expert_parallel

        def counted(*a, _calls=calls, **k):
            _calls.append(threading.current_thread().name)
            return real(*a, **k)

        moe.expert_parallel = counted
        try:
            with PS.sharding_scope(mesh, "2d"):
                loss, _ = M.loss_fn(model, run, batch)
            box = {}
            t = threading.Thread(target=lambda: box.update(
                g=torch.autograd.grad(loss, list(params))), name="bwd")
            t.start()
            t.join(120)
            assert not t.is_alive()
        finally:
            moe.expert_parallel = real
        out[key] = (float(loss.detach()), box["g"], calls)
    assert out["global"][2] == []
    assert out["mesh"][2] == [threading.current_thread().name, "bwd"]
    assert out["mesh"][0] == pytest.approx(out["global"][0], rel=REL)
    for n, g, w in zip(names, out["mesh"][1], out["global"][1]):
        assert _rel(g, w) <= 1e-4, n


# --- chip_smoke.py's gate of the branch (phases 14 and 16) -----------------

@pytest.fixture
def cpu_smoke(monkeypatch):
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    return chip_smoke


def _gate(cpu_smoke, dtype, calls=2):
    """Two MoE calls on a 2 x 2 mesh, recorded and checked. Widths 64 and
    128 with weights at 1/sqrt(fan-in): at 16 wide the ranks' partials
    nearly cancel in some tokens, and their bf16 roundings then move those
    tokens by more than MOE_LAYER_TOL of the mean token norm."""
    d, f, E = 64, 128, 8
    rng = np.random.default_rng(11)

    def w(*shape):
        return torch.as_tensor(rng.standard_normal(shape)
                               / np.sqrt(shape[-2])).to(dtype)

    p = {"router": w(d, E), "wg": w(E, d, f), "wu": w(E, d, f),
         "wd": w(E, f, d)}
    x = torch.as_tensor(rng.standard_normal((4, 32, d))).to(dtype)
    cfg = MoEConfig(n_experts=E, top_k=2, d_ff_expert=f, capacity_factor=0.5)
    with PS.sharding_scope(_mesh((2, 2)), "2d"), \
            cpu_smoke.EPRecorder(moe, T) as rec:
        for i in range(calls):
            T.moe_ffn(p, x[:, 8 * i:], cfg)
    return cpu_smoke.moe_ep_check(rec.calls, cfg, moe)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_card_gate_passes_the_branch(cpu_smoke, dtype):
    res = _gate(cpu_smoke, dtype)
    assert cpu_smoke.moe_ep_ok(res), res
    assert res["calls"] == 2 and res["shards_x_ranks"] == [(2, 2)]
    assert res["rank_sum_mismatch"] == 0 and res["ep_drops"] > 0


# fault -> ((old, new) source edits of moe.expert_parallel, the gate's
# figure that must catch it)
EP_FAULTS = {
    "global_capacity": (
        (("cap = capacity(t_loc, cfg)", "cap = capacity(T, cfg)"),),
        lambda r: r["ep_cap_mismatch"] > 0),
    "rank_offset_off_by_one": (      # rank r runs rank r + 1's weights
        (("p[n][off:off + e_loc]",
          "p[n][(off + e_loc) % cfg.n_experts:][:e_loc]"),),
        lambda r: r["ep_err"] > r["ep_tol"]),
    "aux_summed": (
        (("torch.stack(auxes).mean()", "torch.stack(auxes).sum()"),),
        lambda r: r["aux_rel_err"] > r["aux_tol"]),
    "partial_summed_before_cast": (
        ((".to(xt.dtype).to(dev0)", ".to(dev0)"),
         ("ys.append(y_b.to(xt.device))",
          "ys.append(y_b.to(xt.dtype).to(xt.device))")),
        lambda r: r["rank_sum_mismatch"] > 0),
}


def _mutant(edits):
    """``moe.expert_parallel`` rebuilt from its source with ``edits``,
    looking up the module's globals (so the gate's recorders see it)."""
    src = textwrap.dedent(inspect.getsource(moe.expert_parallel))
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    code = compile(src, "<fault>", "exec")
    fn = next(c for c in code.co_consts if isinstance(c, types.CodeType))
    return types.FunctionType(fn, vars(moe))


@pytest.mark.parametrize("fault", sorted(EP_FAULTS))
def test_card_gate_fails_each_named_fault_in_bf16(cpu_smoke, monkeypatch,
                                                  fault):
    edits, caught = EP_FAULTS[fault]
    monkeypatch.setattr(moe, "expert_parallel", _mutant(edits))
    res = _gate(cpu_smoke, torch.bfloat16)
    assert caught(res) and not cpu_smoke.moe_ep_ok(res), res


def test_mutant_without_edits_passes(cpu_smoke, monkeypatch):
    monkeypatch.setattr(moe, "expert_parallel", _mutant(()))
    assert cpu_smoke.moe_ep_ok(_gate(cpu_smoke, torch.bfloat16))


# --- chip_smoke.py's mesh phases, rehearsed on the CPU at reduced size -------

def _cpu_phase(cpu_smoke, monkeypatch):
    """No card: no CUDA synchronisation or memory stats, a device-events
    stub, and a launch counter on the flash wrapper (the kernels' plain
    versions run on CPU tensors and count nothing)."""
    from repro_torch.kernels import flash_attention as fa
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cpu_smoke, "device_events", lambda fn: (
        fn(), {"device_events": 0, "device_ms": 0.0})[1])
    real = fa.flash_attention

    def counted(*a, **k):
        counted.launches += 1
        return real(*a, **k)

    counted.launches = 0
    monkeypatch.setattr(fa, "flash_attention", counted)
    return counted


def test_mesh_serving_phase_passes_on_reduced_kimi(cpu_smoke, monkeypatch):
    flash = _cpu_phase(cpu_smoke, monkeypatch)
    monkeypatch.setattr(cpu_smoke, "S_MAX", 40)
    cfg = dataclasses.replace(get_reduced("kimi-k2-1t-a32b", layers=1),
                              dtype="bfloat16")
    model = M.build_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)))
    fed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 3)))
    run = RunConfig(arch="k", attn_impl="flash", remat="none")
    got = cpu_smoke.moe_mesh_serving(M, model, run, tokens, fed,
                                     {"flash": (flash, 1)}, "kimi")
    assert got == {"flash": 2} and flash.launches == 3


def test_mesh_train_step_phase_passes_on_reduced_kimi(cpu_smoke,
                                                      monkeypatch):
    flash = _cpu_phase(cpu_smoke, monkeypatch)
    cfg = dataclasses.replace(get_reduced("kimi-k2-1t-a32b", layers=1),
                              dtype="bfloat16")
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    run = RunConfig(arch="k", attn_impl="flash", remat="block")
    from repro_torch.optim import adamw
    got = cpu_smoke.moe_mesh_train_step(M, adamw, cfg, run, batch,
                                        {"flash": (flash, 2)}, "kimi")
    assert got == {"flash": 2} and flash.launches == 4
