"""Training the moe and hybrid families: ``launch.train`` for them, the cut
configurations ``chip_smoke.py`` trains on the card, what the card run
changed, and the card's MoE train-step gate on the CPU.

``launch.train`` takes jamba-v0.1-52b, arctic-480b and kimi-k2 (reduced,
``--device cpu``) and refuses ``--full`` before allocating, naming the
bytes of weights, gradients and AdamW state (the card mocked). The three
cuts of ``chip_smoke.MOE_TRAIN_PHASES`` have the parameter counts
``PERF.md`` §4 gives. Pinned fixes: the router's backward runs without
TF32, as its forward does, whatever the process's switch says; the
``Trainer`` builds the local-SGD outer state only when it is read. The
gate (``chip_smoke.check_moe_train_step``, on reduced f32 models) passes
the clean kernel path, confirms that ``remat="block"``'s recompute routes
as the forward did, and fails named faults: the aux dropped by the decoder
or left out of the loss, a router gradient zeroed, and a recompute that
routes otherwise.
"""
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_ref
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import layer_specs
from repro_torch.models.params import count_params
from repro_torch.optim import adamw
from repro_torch.optim.localsgd import outer_init
from repro_torch.runtime import train_loop as tl

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("jamba-v0.1-52b", "arctic-480b", "kimi-k2-1t-a32b")


@pytest.fixture(autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


# --- launch.train ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "arctic-480b"])
def test_train_launcher_trains_reduced_moe_and_hybrid_on_the_cpu(
        arch, tmp_path, capsys):
    from repro_torch.launch import train as train_launch
    assert set(ARCHS) <= set(train_launch.TRAIN_ARCHS)
    assert not {"seamless-m4t-medium", "internvl2-1b"} & set(
        train_launch.TRAIN_ARCHS)
    assert train_launch.main(["--arch", arch, "--device", "cpu",
                              "--steps", "2", "--seq", "64", "--batch", "2",
                              "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    loss = float(re.search(r"final loss (\S+)", out).group(1))
    assert f"training {arch} (reduced) on cpu" in out
    assert torch.isfinite(torch.tensor(loss))


def test_train_launcher_refuses_full_state_the_card_cannot_hold(
        monkeypatch):
    """``--full`` of a model whose weights, gradients and AdamW state (16
    bytes a bf16 parameter) exceed the card's free memory raises before
    any allocation, naming both byte counts."""
    from repro_torch.launch import train as train_launch
    free = 79_000_000_000
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 85_000_000_000))

    def no_trainer(*a, **k):
        raise AssertionError("the Trainer was built")

    monkeypatch.setattr(train_launch, "Trainer", no_trainer)
    for arch in ARCHS:
        need = count_params(get_config(arch)) * 16
        assert train_launch.train_state_bytes(get_config(arch)) == need
        with pytest.raises(MemoryError) as err:
            train_launch.main(["--arch", arch, "--full"])
        assert f"{need:,}" in str(err.value) and f"{free:,}" in str(err.value)
        assert need > 8e11
    small = get_config("mamba2-370m")
    train_launch.check_fits(small, torch.device("cuda"))
    assert train_launch.train_state_bytes(small) < free


# --- the cuts chip_smoke.py trains ------------------------------------------

# total parameters of each cut by ModelConfig.param_counts(), as PERF.md §4
# lists them
CUT_TOTALS = {"jamba": 4_107_025_024, "arctic": 1_517_630_464,
              "kimi": 3_213_235_200}


def _cut(arch, layers, experts):
    full = get_config(arch)
    return dataclasses.replace(full, n_layers=layers, moe=dataclasses.replace(
        full.moe, n_experts=experts))


def test_training_cuts_keep_published_widths_and_perf_md_counts():
    import chip_smoke
    perf = (REPO / "PERF.md").read_text()
    cells = perf[perf.index("## 4. Cells"):perf.index("## 5.")]
    assert [p[1] for p in chip_smoke.MOE_TRAIN_PHASES] == list(CUT_TOTALS)
    for num, label, arch, layers, experts, batch in \
            chip_smoke.MOE_TRAIN_PHASES:
        full, cut = get_config(arch), _cut(arch, layers, experts)
        for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "ssm", "attn_period", "attn_offset"):
            assert getattr(cut, k) == getattr(full, k), k
        for k in ("top_k", "d_ff_expert", "capacity_factor",
                  "n_shared_experts", "dense_residual", "every_k_layers"):
            assert getattr(cut.moe, k) == getattr(full.moe, k), k
        total = cut.param_counts()["total"]
        assert total == CUT_TOTALS[label]
        assert f"{total:,}" in cells, label
        # 16 bytes a parameter fit one 80 GB card
        assert count_params(cut) * 16 < 80e9
        assert batch in (8, 4, 2, 1)
    jamba = _cut("jamba-v0.1-52b", 8, 3)
    specs = [(s.mixer, s.is_moe) for s in layer_specs(jamba)]
    assert specs.count(("attn", True)) == 1
    assert ("ssm", True) in specs and ("ssm", False) in specs
    with pytest.raises(ValueError):
        M.build_model(_cut("jamba-v0.1-52b", 4, 3), device="cpu")


# --- the fixes the card run made -------------------------------------------

class _TF32AtProducts(TorchDispatchMode):
    """Records the process's TF32 switch at every matrix product."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.seen.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def test_router_backward_runs_without_tf32_like_its_forward(monkeypatch):
    cfg = get_reduced("kimi-k2-1t-a32b", n_experts=16).moe
    x = torch.randn(12, 64, requires_grad=True)
    w = torch.randn(64, cfg.n_experts, requires_grad=True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with _TF32AtProducts() as mode:
        top_p, top_i, aux = moe.route(w, x, cfg)
        (top_p.sum() + aux).backward()
    assert len(mode.seen) >= 3 and not any(mode.seen)
    assert torch.backends.cuda.matmul.allow_tf32
    # the same values and gradients as the plain product
    x2, w2 = x.detach().clone().requires_grad_(), \
        w.detach().clone().requires_grad_()
    probs = torch.softmax(x2 @ w2, -1)
    p2 = probs.gather(1, top_i)
    p2 = p2 / p2.sum(-1, keepdim=True)
    me = probs.mean(0)
    top1 = torch.bincount(top_i[:, 0], minlength=cfg.n_experts) / 12
    (p2.sum() + cfg.n_experts * (me * top1).sum()).backward()
    torch.testing.assert_close(top_p, p2.detach())
    torch.testing.assert_close(w.grad, w2.grad)
    torch.testing.assert_close(x.grad, x2.grad)


def test_trainer_builds_the_outer_state_only_when_read(tmp_path):
    """A card that holds weights, gradients and AdamW state (16 bytes a
    parameter) of jamba's cut has no room for the reference's eagerly
    built, never read local-SGD state (8 more)."""
    cfg = get_reduced("arctic-480b", layers=2, d_model=64, vocab=256)
    run = RunConfig(arch="a", attn_impl="flash", remat="block",
                    total_steps=2, warmup_steps=1)
    tr = tl.Trainer(cfg, run, tl.TrainLoopConfig(
        total_steps=2, ckpt_every=10, ckpt_dir=str(tmp_path)),
        batch_override=2, seq_override=32, device="cpu")
    assert tr._outer is None
    tr.run_steps()
    assert tr._outer is None
    want = outer_init(tr.params)
    got = tr.outer
    assert got is tr.outer
    assert all(torch.equal(got.anchor[k], want.anchor[k]) for k in want.anchor)
    assert all(not got.momentum[k].any() for k in want.momentum)


# --- the card's MoE train-step gate on the CPU ------------------------------

def _counting(real):
    def wrapper(*a, **k):
        wrapper.launches += 1
        return real(*a, **k)
    wrapper.launches = 0
    return wrapper


@pytest.fixture
def gate(monkeypatch):
    """``chip_smoke`` on the CPU with counting kernel wrappers (on CPU
    tensors the real ones run their plain versions and count nothing)."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(fa, "flash_attention", _counting(fa.flash_attention))
    monkeypatch.setattr(ssd, "ssd_scan", _counting(ssd.ssd_scan))
    return chip_smoke


def _gate_case(arch):
    """A reduced f32 model of ``arch`` with its kernels' expected launches
    (remat="block": each forward twice) and a 2 x 64 batch."""
    if arch == "jamba-v0.1-52b":
        cfg = get_reduced(arch, layers=8)
    else:
        cfg = get_reduced(arch, layers=1, n_experts=16)
    cfg = dataclasses.replace(cfg, dtype="float32")
    specs = layer_specs(cfg)
    n_attn = sum(s.mixer == "attn" for s in specs)
    kernels = {"flash": (fa.flash_attention, 2 * n_attn)}
    if n_attn < len(specs):
        kernels["ssd"] = (ssd.ssd_scan, 2 * (len(specs) - n_attn))
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
             for k in ("tokens", "targets")}
    run = RunConfig(arch=arch, attn_impl="flash", remat="block")
    return cfg, run, batch, kernels


def _no_aux_in_loss(real):
    def loss_fn(model, run, batch, **kw):
        loss, mm = real(model, run, batch, **kw)
        return loss - model.cfg.moe.aux_loss_weight * mm["aux"], mm
    return loss_fn


def _zero_router_grad(real):
    def route(w, x, cfg):
        return real(w * 0.0 + w.detach(), x, cfg)
    return route


def _recompute_routes_otherwise(real):
    seen = set()

    def route(w, x, cfg):
        top_p, top_i, aux = real(w, x, cfg)
        if id(w) in seen:
            top_i = (top_i + 1) % cfg.n_experts
        seen.add(id(w))
        return top_p, top_i, aux
    return route


# fault -> (module, name, maker, the gate's check that must catch it)
FAULTS = {
    "aux_dropped_by_decoder": (T, "_add_aux", lambda real: (
        lambda total, aux: total),
        lambda r: r["aux_rel_diff"] > r["tol_aux_rel"]),
    "aux_left_out_of_loss": (M, "loss_fn", _no_aux_in_loss,
                             lambda r: r["plain_loss_vs_nll_plus_aux"]
                             > r["tol_loss_rel"]),
    "router_gradient_zeroed": (moe, "route", _zero_router_grad,
                               lambda r: r["router_gnorm_kernel"] == 0.0
                               and r["router_gnorm_rel_diff"]
                               > r["tol_gnorm_rel"]),
    "recompute_routes_otherwise": (moe, "route", _recompute_routes_otherwise,
                                   lambda r: r["remat_choice_mismatch"] > 0),
}


@pytest.mark.parametrize("case", ["clean"] + list(FAULTS))
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_moe_train_step_gate_fails_named_faults(arch, case, gate,
                                                monkeypatch, capsys):
    cfg, run, batch, kernels = _gate_case(arch)
    label = "moe_train_step_check"
    if case in FAULTS:
        mod, name, make, caught = FAULTS[case]
        monkeypatch.setattr(mod, name, make(getattr(mod, name)))
        with pytest.raises(RuntimeError, match="disagrees"):
            gate.check_moe_train_step(M, adamw, moe, cfg, run, batch,
                                      kernels, label)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert caught(res[label]), res
        return
    res = gate.check_moe_train_step(M, adamw, moe, cfg, run, batch, kernels,
                                    label)
    assert res["remat_choice_mismatch"] == 0
    assert res["route_calls"] == 2 * res["moe_layers"] > 0
    assert res["launches_kernel_path"] == {n: e for n, (_, e)
                                           in kernels.items()}
    assert res["loss_rel_diff"] <= 1e-6 and res["aux_rel_diff"] <= 1e-6
    assert res["aux_kernel"] > 0.5 and res["router_gnorm_kernel"] > 0
