"""The plain reference against ``repro_torch`` at reduced sizes in
float32 on the CPU (the test imports both; the reference imports
neither), and the reference's own independence."""
import ast
import dataclasses
import subprocess
import sys

import pytest
import torch

from cellbench.bench import PKG, ROOT
from cellbench.reference import decoder as R
from cellbench.reference import family
from cellbench.weights import make_weights


def tiny(arch: str, **kw):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    layers = 8 if arch.startswith("jamba") else 2
    cfg = reduced(get_config(arch), layers=layers)
    return dataclasses.replace(cfg, dtype="float32", **kw)


def fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_loss_and_gradients_match_the_port(arch):
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    cfg = tiny(arch)
    w = make_weights(cfg, 5, torch.device("cpu"))
    model = M.Transformer(cfg, {k: v.clone() for k, v in w.items()})
    model.requires_grad_(True)
    run = RunConfig(arch=cfg.name, attn_impl="flash", remat="block")
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    lp, _ = M.loss_fn(model, run, {"tokens": tok, "targets": tgt})
    names = [n for n, _ in model.named_parameters()]
    gp = torch.autograd.grad(lp, [p for _, p in model.named_parameters()])
    m = fields(cfg)
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    lr = R.loss(R.Ops(params, "f32"), m, family(cfg.family).kinds(m), tok,
                tgt)
    gr = torch.autograd.grad(lr, [params[n] for n in names])
    assert float(lr.detach()) == pytest.approx(float(lp.detach()), rel=1e-5)
    for n, a, b in zip(names, gp, gr):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-6), n


@pytest.mark.parametrize("arch,cap", [("mamba2-370m", None),
                                      ("jamba-v0.1-52b", None),
                                      ("jamba-v0.1-52b", 0.5)])
def test_prefill_and_cached_decode_match_the_port(arch, cap):
    """Prefill's last logits and each cached decode step's logits against
    the reference serving the same batch; ``cap`` 0.5 drops assignments
    past the experts' capacity, which the reference must drop alike."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    cfg = tiny(arch)
    if cap is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cap))
    w = make_weights(cfg, 6, torch.device("cpu"))
    model = M.Transformer(cfg, w)
    run = RunConfig(arch=cfg.name, attn_impl="flash", remat="none")
    tok = torch.randint(0, cfg.vocab_size, (3, 64),
                        generator=torch.Generator().manual_seed(2))
    lg, cache = M.prefill(model, run, tok, 72)
    got, fed = [lg], [lg.argmax(-1)]
    for i in range(4):
        lg, cache = M.decode_step(model, run, fed[-1][:, None], cache, 64 + i)
        got.append(lg)
        fed.append(lg.argmax(-1))
    served = [[int(t[j]) for t in fed] for j in range(3)]
    served[1] = served[1][:2]          # a request done early stays a row
    m = fields(cfg)
    out = R.serve_follow(w, m, family(cfg.family).kinds(m), tok, served)
    for t, (a, b) in enumerate(zip(got, out["logits"])):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), t
    assert max(max(r) for r in out["gaps"]) < 1e-4


def test_train_follow_matches_the_port_step():
    """Three AdamW steps of the reference against the port's train step:
    losses, the first clipped gradient and the master weights' change."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import make_train_step
    cfg = tiny("mamba2-370m")
    w = make_weights(cfg, 7, torch.device("cpu"))
    run = RunConfig(arch=cfg.name, attn_impl="flash", remat="block")
    model = M.Transformer(cfg, {k: v.clone() for k, v in w.items()})
    model.requires_grad_(True)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, run)
    g = torch.Generator().manual_seed(3)
    batches = [(torch.randint(0, cfg.vocab_size, (2, 64), generator=g),
                torch.randint(0, cfg.vocab_size, (2, 64), generator=g))
               for _ in range(3)]
    losses = []
    for i, (t, y) in enumerate(batches):
        losses.append(float(step(model, opt, {"tokens": t,
                                              "targets": y})["loss"]))
        if i == 0:
            g1 = {k: float(v.norm()) / (1 - run.beta1)
                  for k, v in opt.m.items()}
    m = fields(cfg)
    runf = {k: getattr(run, k) for k in ("lr", "warmup_steps", "total_steps",
                                         "beta1", "beta2", "weight_decay",
                                         "grad_clip")}
    ref = R.train_follow(w, m, family("ssm").kinds(m), runf, batches)
    assert ref["loss"] == pytest.approx(losses, rel=1e-5)
    for k in w:
        assert ref["grad1"][k] == pytest.approx(g1[k], rel=1e-3, abs=1e-9)
        assert ref["change"][k] == pytest.approx(
            float((opt.master[k] - w[k]).norm()), rel=1e-3, abs=1e-9)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro", "repro_torch", "jax",
                                               "jaxlib", "flax"), (path, n)
    code = ("import sys, cellbench.reference.decoder, "
            "cellbench.reference.ssm, cellbench.reference.hybrid; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    top = set(eval(out.stdout))
    assert not top & {"repro", "repro_torch", "jax", "jaxlib", "flax"}
