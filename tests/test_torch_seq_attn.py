"""The port's sequence-parallel attention (``repro_torch/models/layers.py``
``seq_parallel_attention`` over ``shard_map``, a loop over a
``HostMesh``) against the reference's ``shard_map`` version, which runs
in a child process on 4 forced host devices, on the CPU.

(a) The attention alone, f32, within 1e-5 of each one's largest value:
on 1 x 4 and 2 x 2 meshes, under ``seq_attn_rules("2d")`` and
``"fsdp"``, causal global, windowed with the band and windowed without
it, on the naive path and the blockwise one (``block_kv`` below the
band); the output and the gradients of q, k and v (the reference's by
``jax.grad`` over its ``shard_map``, the port's by autograd through the
rank loop). The band is taken where the reference takes it, and
``flash`` inside the branch is the blockwise path.

(b) Reduced gemma3-12b (a local and a global layer) and reduced kimi-k2
(one MoE layer over 4 experts, one a rank) under a 1 x 4 mesh and
``seq_attn_rules("2d")`` against the reference under the same mesh:
prefill's logits within 1e-4, ``loss_fn`` within 1e-5 and every weight's
gradient within 1e-4.

(c) Faults put into a copy of the port's source each fail (a)'s gate.
Then ``chip_smoke.py``'s phase 9b rehearsed at reduced size, and its gate
against two of the faults (phase 19's mesh step, its 1 x 4 seq-parallel
row included, is rehearsed in ``tests/test_torch_moe_ep.py``).
"""
import dataclasses
import inspect
import textwrap
import types

import numpy as np
import pytest
import torch

import _torch_ref as ref
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.kvcache import layer_specs
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import pspec as PS

REL = 1e-5
LOGIT_REL, LOSS_REL, GRAD_REL = 1e-4, 1e-5, 1e-4
CASES = {c[0]: c for c in ref.seq_attn_cases()}


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref.run_reference("seq_attn", tmp_path_factory.mktemp("ref")
                             / "seq_attn.npz", host_devices=ref.SEQ_DEVICES)


@pytest.fixture(scope="module")
def reference_models(tmp_path_factory):
    return ref.run_reference("seq_models", tmp_path_factory.mktemp("ref")
                             / "seq_models.npz",
                             host_devices=ref.SEQ_DEVICES)


def _mesh(shape):
    return PS.HostMesh(np.full(shape, "cpu", dtype=object),
                       ("data", "model"))


def _rules(name):
    return PS.seq_attn_rules("2d") if name == "seq_2d" else name


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _run(case, impl=None):
    """The port's seq_parallel_attention on the case's inputs under its
    mesh and rules (at ``impl`` if given) -> (out, {"q", "k", "v":
    gradient of sum(out * cot)})."""
    name, shape, rules, window, case_impl, bk = case
    arrs = {k: torch.as_tensor(v) for k, v in ref.seq_attn_inputs().items()}
    cot = arrs.pop("cot")
    for t in arrs.values():
        t.requires_grad_(True)
    with PS.sharding_scope(_mesh(shape), _rules(rules)):
        assert layers.use_seq_parallel(arrs["q"], arrs["k"])
        out = layers.seq_parallel_attention(
            arrs["q"], arrs["k"], arrs["v"], causal=True, window=window,
            impl=impl or case_impl, block_kv=bk)
    grads = torch.autograd.grad((out * cot).sum(), list(arrs.values()))
    return out.detach(), dict(zip("qkv", grads))


def _errors(reference, case, **kw) -> dict:
    out, grads = _run(case, **kw)
    name = case[0]
    errs = {"out": _rel(out, reference[f"{name}/out"])}
    for k, g in grads.items():
        errs[f"grad_{k}"] = _rel(g, reference[f"{name}/grad/{k}"])
    return errs


class KeyLengths:
    """Records the key length each rank's attention path sees (the naive
    ``_sdpa`` and the blockwise ``_blockwise_sdpa``, which
    ``rank_attention`` looks up at call time)."""

    def __init__(self, monkeypatch):
        self.seen = []
        for name in ("_sdpa", "_blockwise_sdpa"):
            real = getattr(layers, name)

            def rec(q, k, *a, _real=real, _name=name, **kw):
                self.seen.append((_name, k.shape[1]))
                return _real(q, k, *a, **kw)

            monkeypatch.setattr(layers, name, rec)


# --- (a) the attention against the reference's ---------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_parallel_attention_matches_reference(reference, name,
                                                  monkeypatch):
    case = CASES[name]
    keys = KeyLengths(monkeypatch)
    errs = _errors(reference, case)
    assert max(errs.values()) <= REL, errs
    _, shape, _, window, impl, bk = case
    sl = ref.SEQ_S // shape[1]
    band = window is not None and sl + window < ref.SEQ_S
    want_len = sl + window if band else ref.SEQ_S
    path = "_sdpa" if impl == "naive" or want_len <= bk else \
        "_blockwise_sdpa"
    assert keys.seen == [(path, want_len)] * (shape[0] * shape[1])
    assert band == ("_band_" in name)


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n.endswith("blockwise")))
def test_flash_inside_the_branch_is_the_blockwise_path(reference, name):
    out, grads = _run(CASES[name], impl="flash")
    want_out, want_grads = _run(CASES[name])
    assert torch.equal(out, want_out)
    assert all(torch.equal(grads[k], want_grads[k]) for k in grads)
    assert _rel(out, reference[f"{name}/out"]) <= REL


def test_shard_map_slices_by_spec_and_joins_in_order():
    """Each coordinate sees its own slices and index; the outputs join
    row-major over a tuple entry's axes, and replicas along an unnamed
    axis keep the first."""
    mesh = _mesh((2, 3))
    x = torch.arange(12 * 5, dtype=torch.float32).reshape(12, 5)
    seen = []

    def f(coord, xl):
        seen.append((coord["data"], coord["model"], tuple(xl.shape)))
        return xl + 0

    got = layers.shard_map(f, mesh=mesh, in_specs=((("data", "model"),
                                                    None),),
                           out_specs=(("data", "model"), None))(x)
    assert torch.equal(got, x)
    assert seen == [(d, m, (2, 5)) for d in range(2) for m in range(3)]
    got = layers.shard_map(lambda c, xl: xl * 0 + c["model"], mesh=mesh,
                           in_specs=(("model", None),),
                           out_specs=("model", None))(x)
    assert torch.equal(got[:, 0], torch.arange(3).repeat_interleave(4)
                       .float())
    with pytest.raises(ValueError, match="do not tile"):
        layers.shard_map(lambda c, xl: xl[:c["model"] + 1], mesh=mesh,
                         in_specs=(("model", None),),
                         out_specs=("model", None))(x)
    with pytest.raises(TypeError, match="places nothing"):
        layers.shard_map(f, mesh=PS.abstract_mesh((2,), ("data",)),
                         in_specs=((None,),), out_specs=(None,))


# --- (b) reduced models under a 1 x 4 mesh against the reference's --------

def _model_state(reference_models, label, cfg):
    """The reference's weights (PRNGKey(0)) as the port's state dict."""
    return params_from_jax(ref.nest(reference_models, f"{label}/param/"),
                           cfg, device="cpu")


def _model_case(label):
    return next(m for m in ref.SEQ_MODELS if m[0] == label)


def _cfg(label):
    _, arch, layers_, impl, bk = _model_case(label)
    cfg = dataclasses.replace(get_reduced(arch, layers=layers_),
                              dtype="float32")
    return cfg, impl, bk


@pytest.mark.parametrize("label,port_impl", [("gemma", "flash"),
                                             ("kimi", "naive")])
def test_prefill_under_1x4_seq_rules_matches_reference(reference_models,
                                                       label, port_impl):
    cfg, _, bk = _cfg(label)
    model = M.Transformer(cfg, _model_state(reference_models, label, cfg))
    tok = torch.as_tensor(ref.seq_model_tokens(cfg.name)).long()
    run = RunConfig(arch=cfg.name, attn_impl=port_impl, attn_block_kv=bk,
                    remat="none")
    calls = []
    real = layers.seq_parallel_attention

    def counted(*a, **k):
        calls.append(k["window"])
        return real(*a, **k)

    layers.seq_parallel_attention = counted
    try:
        with PS.sharding_scope(_mesh((1, 4)), PS.seq_attn_rules("2d")):
            logits, _ = M.prefill(model, run, tok[:, :-1], ref.SEQ_S + 4)
    finally:
        layers.seq_parallel_attention = real
    assert len(calls) == sum(s.mixer == "attn" for s in layer_specs(cfg))
    assert _rel(logits, reference_models[f"{label}/logits"]) <= LOGIT_REL
    if label == "gemma":
        assert sorted(calls, key=str) == [16, None]  # a local and a global


@pytest.mark.parametrize("label", ["gemma", "kimi"])
def test_loss_and_grads_under_1x4_seq_rules_match_reference(
        reference_models, label):
    cfg, impl, bk = _cfg(label)
    model = M.Transformer(cfg, _model_state(reference_models, label,
                                            cfg)).requires_grad_(True)
    tok = torch.as_tensor(ref.seq_model_tokens(cfg.name)).long()
    run = RunConfig(arch=cfg.name, attn_impl=impl, attn_block_kv=bk,
                    remat="block")
    with PS.sharding_scope(_mesh((1, 4)), PS.seq_attn_rules("2d")):
        loss, mets = M.loss_fn(model, run, {"tokens": tok[:, :-1],
                                            "targets": tok[:, 1:]},
                               xent_chunk=0)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, list(params))
    assert _rel(loss.detach(), reference_models[f"{label}/loss"]) <= LOSS_REL
    assert _rel(mets["aux"], reference_models[f"{label}/aux"]) <= LOSS_REL
    want = params_from_jax(ref.nest(reference_models, f"{label}/grad/"),
                           cfg, device="cpu")
    assert set(names) == set(want)
    errs = {n: _rel(g, want[n]) for n, g in zip(names, grads)}
    assert max(errs.values()) <= GRAD_REL, errs


# --- (c) faults in the port's source fail (a)'s gate -----------------------

# fault -> (function of models/layers.py, its (old, new) source edits)
FAULTS = {
    "q_start_off_by_one": ("seq_parallel_attention", (
        ("q_start=r * ql.shape[1],", "q_start=r * ql.shape[1] + 1,"),)),
    "band_start_not_clipped": ("rank_attention", (
        ("start = min(max(q_start - window, 0), S_kv - band)",
         "start = q_start - window"),)),
    "ranks_out_of_order": ("_join", (
        ("torch.cat(parts, dim=d)", "torch.cat(parts[::-1], dim=d)"),)),
    "window_applied_twice": ("rank_attention", (
        ("max(q_start - window, 0)", "max(q_start - 2 * window, 0)"),)),
}


def mutant(name: str, edits):
    """``layers.<name>`` rebuilt from its source with ``edits``, looking
    up the module's globals."""
    src = textwrap.dedent(inspect.getsource(getattr(layers, name)))
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    code = compile(src, "<fault>", "exec")
    fn = next(c for c in code.co_consts if isinstance(c, types.CodeType))
    real = getattr(layers, name)
    out = types.FunctionType(fn, vars(layers), name, real.__defaults__)
    out.__kwdefaults__ = real.__kwdefaults__
    return out


def _gate(reference) -> dict:
    """(a)'s gate over every case: the largest error of each."""
    return {name: max(_errors(reference, case).values())
            for name, case in CASES.items()}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_named_fault_fails_the_gate(reference, monkeypatch, fault):
    fn, edits = FAULTS[fault]
    monkeypatch.setattr(layers, fn, mutant(fn, edits))
    errs = _gate(reference)
    failed = [n for n, e in errs.items() if not e <= REL]
    assert failed, errs
    if fault in ("band_start_not_clipped", "window_applied_twice"):
        assert all("_band_" in n for n in failed), failed


def test_mutants_without_edits_pass(reference, monkeypatch):
    for fn in {f for f, _ in FAULTS.values()}:
        monkeypatch.setattr(layers, fn, mutant(fn, ()))
    errs = _gate(reference)
    assert max(errs.values()) <= REL, errs


# --- chip_smoke.py's phase 9b rehearsed on the CPU at reduced size ---------

@pytest.fixture
def cpu_smoke(monkeypatch):
    """No card: no CUDA synchronisation, a device-events stub, a launch
    counter on the flash wrapper (its plain version runs on CPU tensors)
    and a cache long enough for 32 tokens."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "S_MAX", 36)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "device_events", lambda fn: (
        fn(), {"device_events": 0, "device_ms": 1.0})[1])
    real = fa.flash_attention

    def counted(*a, **k):
        counted.launches += 1
        return real(*a, **k)

    counted.launches = 0
    monkeypatch.setattr(fa, "flash_attention", counted)
    return chip_smoke, counted


def _phase_9b(chip_smoke, flash):
    """Reduced gemma3 (4 layers: 2 local with window 16, 2 global) in
    bf16, 4 x 32 tokens: over 4 ranks of 8 queries the local layers take
    the band of 24 keys, block_kv 8 sends every rank blockwise."""
    cfg = dataclasses.replace(get_reduced("gemma3-12b", layers=4),
                              dtype="bfloat16")
    model = M.build_model(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (4, 32)))
    run = RunConfig(arch="g", attn_impl="flash", attn_block_kv=8,
                    remat="none")
    logits, _ = M.prefill(model, run, tokens, chip_smoke.S_MAX)
    flash.launches = 0
    return chip_smoke.seq_prefill(M, model, run, tokens, logits, flash,
                                  "card, 700.00 W")


def test_seq_prefill_phase_passes_on_reduced_gemma(cpu_smoke):
    chip_smoke, flash = cpu_smoke
    res, launches = _phase_9b(chip_smoke, flash)
    assert launches == 4 and flash.launches == 4
    c, k = res["check"], res["control"]
    assert (c["band"], c["full"], c["other"]) == (2, 2, 0)
    assert c["max_rel_rms"] <= chip_smoke.SEQ_ATTN_TOL_REL_RMS \
        < k["min_rel_rms"]
    assert c["logits_vs_unmeshed_flash_rel"] <= chip_smoke.LOGIT_TOL_REL \
        < k["logits_vs_unmeshed_flash_rel"]


@pytest.mark.parametrize("fault", ["q_start_off_by_one", "ranks_out_of_order"])
def test_seq_prefill_gate_fails_a_fault(cpu_smoke, monkeypatch, fault):
    chip_smoke, flash = cpu_smoke
    fn, edits = FAULTS[fault]
    monkeypatch.setattr(layers, fn, mutant(fn, edits))
    with pytest.raises(RuntimeError, match="sequence-parallel"):
        _phase_9b(chip_smoke, flash)
