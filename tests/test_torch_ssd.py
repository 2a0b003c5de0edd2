"""The port's SSD scan against the reference's: the plain version (the
chunked algorithm) against ``repro.kernels.ref.ssd_scan_ref`` and against
the Pallas kernel (``repro.kernels.ops.ssd_scan``, interpret mode, as
``tests/test_kernels.py`` runs it), gradients against ``jax.grad``, the
Mamba-2 block with and without the kernel path, the wrapper's dispatch,
the tolerance ``chip_smoke.py`` holds the CUDA kernel to, and — on a GPU
— the kernel against its plain version.

Inputs are made with numpy from a seed. In f32 the tolerances are
relative to the largest output: 1e-5 covers f32 sum-order differences of
two scans over <= 512 steps (measured ~2e-6). In bf16 both sides round
the same f32 result to bf16, so they differ only where a rounding
boundary falls between two f32 results: at most one bf16 ulp of the
largest output, 1e-3 relative RMS.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ref
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm

REPO = Path(__file__).resolve().parents[1]

# (B, S, nh, hd, N, chunk): tests/test_kernels.py's SSD_CASES, and
# mamba2-370m's head_dim, d_state and chunk at S 512
CASES = {
    "case0": (2, 512, 4, 32, 64, 128),
    "paper_state": (1, 256, 2, 64, 128, 256),
    "narrow_heads": (1, 384, 8, 16, 32, 128),
    "mamba2": (1, 512, 2, 64, 128, 256),
}
# edges of the kernel's passes, on the card only: one chunk of 64 (the
# smallest chunk, batch 1, an odd head count), two chunks at batch 1; and
# mamba2-370m's serving prefill (4 x 2048 tokens, 32 heads), whose final
# state becomes the decode state; jamba's (d_state 16, 128 heads) and
# d_state 16 over two chunks at batch 1
EDGES = {
    "one_chunk_64": (1, 64, 3, 16, 16, 64),
    "two_chunks_b1": (1, 128, 2, 32, 32, 64),
    "mamba2_serving_b4": (4, 2048, 32, 64, 128, 256),
    "jamba_serving_d16": (4, 2048, 128, 64, 16, 256),
    "d16_two_chunks_b1": (1, 512, 4, 64, 16, 256),
}
F32_REL = 1e-5
BF16_REL_RMS = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


def _inputs(case, dtype=torch.float32, seed=0):
    """x, B, C unit normals; dt = softplus(normal); A = -exp(normal / 2),
    as tests/test_kernels.py draws them."""
    B, S, nh, hd, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh))))
    A = -np.exp(rng.standard_normal(nh) * 0.5)
    Bm, Cm = (rng.standard_normal((B, S, 1, N)) for _ in range(2))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return (f32(x).to(dtype), f32(dt), f32(A), f32(Bm).to(dtype),
            f32(Cm).to(dtype))


def _jax(t):
    import jax.numpy as jnp
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _assert_close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    top = float(np.abs(want).max())
    if dtype == torch.float32:
        assert float(np.abs(got - want).max()) <= F32_REL * top
    else:
        assert float(np.abs(got - want).max()) <= 2.0 ** (
            math.floor(math.log2(top)) - 7)
        rms = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rms <= BF16_REL_RMS, rms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_sequential_oracle_and_pallas_kernel(name, dtype):
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref
    case = CASES[name]
    x, dt, A, Bm, Cm = _inputs(case, dtype)
    y, h = ssd.ssd_scan(x, dt, A, Bm, Cm, case[-1])
    assert y.dtype == dtype and h.dtype == torch.float32
    y_ref, h_ref = ref.ssd_scan_ref(_jax(x), _jax(dt), _jax(A),
                                    _jax(Bm[:, :, 0]), _jax(Cm[:, :, 0]))
    y_pl, h_pl = ref_ops.ssd_scan(*(_jax(t) for t in (x, dt, A, Bm, Cm)),
                                  case[-1])
    for want_y, want_h in ((y_ref, h_ref), (y_pl, h_pl)):
        _assert_close(y.float().numpy(), want_y, dtype)
        _assert_close(h.numpy(), want_h, torch.float32)
    if name == "mamba2":        # the port's own sequential oracle too
        y_seq, h_seq = port_ref.ssd_scan_ref(x, dt, A, Bm[:, :, 0],
                                             Cm[:, :, 0])
        _assert_close(y_seq.float().numpy(), y_ref, dtype)
        _assert_close(h_seq.numpy(), h_ref, torch.float32)


def test_gradients_match_jax_grad():
    """d/d(x, dt, A, B, C) of <y, gy> + <h, gh> through the port's
    ``ops.ssd_scan`` (backward recomputed through the chunked plain
    version) against ``jax.grad`` through the reference's (backward
    through the sequential oracle), f32."""
    import jax
    from repro.kernels import ops as ref_ops
    case = CASES["case0"]
    ins = _inputs(case, seed=1)
    rng = np.random.default_rng(2)
    B, S, nh, hd, N, chunk = case
    gy = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    gh = rng.standard_normal((B, nh, hd, N)).astype(np.float32)

    def ref_loss(*args):
        y, h = ref_ops.ssd_scan(*args, chunk)
        return (y * gy).sum() + (h * gh).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *(_jax(t) for t in ins))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, h = ops.ssd_scan(*leaves, chunk)
    ((y * torch.tensor(gy)).sum() + (h * torch.tensor(gh)).sum()).backward()
    for name, t, w in zip(("x", "dt", "A", "Bm", "Cm"), leaves, want):
        w = _f32(w)
        err = float(np.abs(t.grad.numpy() - w).max() / np.abs(w).max())
        assert err <= 1e-4, (name, err)


# --- the bound chip_smoke.py holds the kernel to -------------------------------

def _kernel_arithmetic(x, dt, A, Bm, Cm, chunk, *, carry=True,
                       inclusive=True, dt_weight=True, bf16_acc=False,
                       split_m=True, split_update=True):
    """The kernel's four passes in f32, with one part broken on request.

    C B^T from the bf16 inputs once per chunk; per (head, chunk) the
    inclusive cumsum and the chunk's own state X^T (w B) with the
    decay-weighted w x split into a bf16 high part and remainder
    (``split_update``; else one bf16); the recurrence over chunks, each
    chunk reading the state before it; then y = e^{cs_i} (C h^T), h split
    in two bf16, plus M X with M = C B^T . L . dt_j split in two bf16
    (``split_m``; else one bf16). ``bf16_acc`` keeps the accumulators in
    bf16. y is rounded to bf16 at the end. A product with a split operand
    is emulated as the product with (high + remainder), which equals the
    two tensor-core products up to f32 sum order."""
    bf = lambda t: t.to(torch.bfloat16).float()
    acc = bf if bf16_acc else (lambda t: t)

    def operand(t, split):
        hi = bf(t)
        return hi + bf(t - hi) if split else hi

    B, S, nh, hd = x.shape
    nc = S // chunk
    xs = x.float().permute(0, 2, 1, 3).reshape(B, nh, nc, chunk, hd)
    dts = dt.float().permute(0, 2, 1).reshape(B, nh, nc, chunk)
    bm = Bm[:, :, 0].float().reshape(B, 1, nc, chunk, -1)
    cm = Cm[:, :, 0].float().reshape(B, 1, nc, chunk, -1)
    da = dts * A[None, :, None, None]
    cs = torch.cumsum(da, -1) if inclusive else torch.cumsum(da, -1) - da
    # pass 1: C B^T once per chunk (heads share B and C)
    cb = cm @ bm.transpose(-1, -2)                       # [B, 1, nc, Q, Q]
    # pass 2: each chunk's own state
    w = torch.exp(cs[..., -1:] - cs) * dts
    states = operand(xs * w[..., None], split_update).transpose(-1, -2) @ bm
    # pass 3: the recurrence; each chunk keeps the state before it
    h = torch.zeros(B, nh, hd, bm.shape[-1])
    before = []
    for c in range(nc):
        before.append(h if carry else torch.zeros_like(h))
        h = acc(h * torch.exp(cs[:, :, c, -1])[..., None, None]
                + states[:, :, c])
    h_prev = torch.stack(before, dim=2)                  # [B, nh, nc, hd, N]
    # pass 4: the outputs
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(
        (cs[..., :, None] - cs[..., None, :]).masked_fill(~tri, -math.inf)),
        0.0)
    m = cb * L
    if dt_weight:
        m = m * dts[..., None, :]
    y_off = acc((cm @ operand(h_prev, True).transpose(-1, -2))
                * torch.exp(cs)[..., None])
    y = acc(y_off + operand(m, split_m) @ xs)
    y = y.reshape(B, nh, S, hd).permute(0, 2, 1, 3)
    return bf(y), h


def test_chip_tolerance_passes_the_kernel_arithmetic_and_fails_faults():
    """``chip_smoke.py``'s bounds on the kernel against its plain version,
    at mamba2-370m's head geometry with the model's dt and A ranges: the
    kernel's own arithmetic stays well inside both; a state not carried
    across chunks, an exclusive cumsum, a missing dt_j weight, a bf16
    accumulator, or a single bf16 rounding of M or of the state update's
    operand (in place of the high part plus remainder) breaks at least
    one."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    rng = np.random.default_rng(7)
    B, S, nh, hd, N, chunk = 1, 1024, 4, 64, 128, 256
    bf = lambda a: torch.tensor(a, dtype=torch.float32).to(
        torch.bfloat16).float()
    x = bf(rng.standard_normal((B, S, nh, hd)))
    Bm, Cm = (bf(rng.standard_normal((B, S, 1, N))) for _ in range(2))
    bias = np.log(np.expm1(rng.uniform(1e-3, 1e-1, nh)))
    dt = torch.tensor(np.log1p(np.exp(
        rng.standard_normal((B, S, nh)) * 0.5 + bias)), dtype=torch.float32)
    A = torch.tensor(-rng.uniform(1.0, 16.0, nh), dtype=torch.float32)
    y_p, h_p = ssd.ssd_chunked(x.to(torch.bfloat16), dt, A,
                               Bm.to(torch.bfloat16), Cm.to(torch.bfloat16),
                               chunk)

    def errors(**fault):
        y, h = _kernel_arithmetic(x, dt, A, Bm, Cm, chunk, **fault)
        return chip_smoke.ssd_errors(y, h, y_p, h_p)

    ok = errors()
    assert ok["y_rel_rms_err"] < chip_smoke.SSD_Y_REL_RMS_TOL / 3, ok
    assert ok["h_rel_rms_err"] < chip_smoke.SSD_H_REL_RMS_TOL / 3, ok
    assert chip_smoke.ssd_ok(ok)
    for fault in ({"carry": False}, {"inclusive": False},
                  {"dt_weight": False}, {"bf16_acc": True},
                  {"split_m": False}, {"split_update": False}):
        assert not chip_smoke.ssd_ok(errors(**fault)), fault


# --- the backward ---------------------------------------------------------------

# (B, S, nh, hd, N, chunk): mamba2's widths (d_state 128) and jamba's
# (d_state 16, more heads) over three chunks
BWD_CASES = {
    "mamba2_like": (1, 768, 2, 64, 128, 256),
    "jamba_like": (2, 384, 8, 64, 16, 128),
}


def _grads_out(case, seed, with_gh):
    """gy [B, S, nh, hd] and, with ``with_gh``, gh [B, nh, hd, N]: unit
    normals in f32."""
    B, S, nh, hd, N, _ = case
    rng = np.random.default_rng(seed)
    gy = torch.tensor(rng.standard_normal((B, S, nh, hd)), dtype=torch.float32)
    gh = (torch.tensor(rng.standard_normal((B, nh, hd, N)),
                       dtype=torch.float32) if with_gh else None)
    return gy, gh


@pytest.mark.parametrize("with_gh", [False, True], ids=["gh_zero", "gh"])
@pytest.mark.parametrize("name", BWD_CASES)
def test_plain_backward_matches_autograd_and_jax_grad(name, with_gh):
    """``ssd_chunked_bwd`` (the closed form, no autograd) against autograd
    through ``ssd_chunked`` and against ``jax.grad`` through the
    reference's ``ssd_scan`` (its backward through the sequential oracle),
    f32, with the final state's gradient zero and not."""
    import jax
    from repro.kernels import ops as ref_ops
    case = BWD_CASES[name]
    chunk = case[-1]
    ins = _inputs(case, seed=5)
    gy, gh = _grads_out(case, 6, with_gh)
    got = ssd.ssd_chunked_bwd(*ins, chunk, gy, gh)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, h = ssd.ssd_chunked(*leaves, chunk)
    loss = (y * gy).sum() + (0 if gh is None else (h * gh).sum())
    auto = torch.autograd.grad(loss, leaves)
    gy_n, gh_n = gy.numpy(), None if gh is None else gh.numpy()

    def ref_loss(*args):
        y, h = ref_ops.ssd_scan(*args, chunk)
        out = (y * gy_n).sum()
        return out if gh_n is None else out + (h * gh_n).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *(_jax(t) for t in ins))
    for gname, t, g, a, w in zip(("x", "dt", "A", "Bm", "Cm"), ins, got,
                                 auto, want):
        assert g.shape == t.shape and g.dtype == t.dtype
        for other in (a.numpy(), _f32(w)):
            err = float(np.abs(g.numpy() - other).max() / np.abs(other).max())
            assert err <= 1e-4, (gname, err)


def _kernel_bwd_arithmetic(x, dt, A, Bm, Cm, chunk, gy, gh, *,
                           state_dx=True, use_gh=True, da_chunks=None):
    """The backward kernels' seven passes in f32, with one part broken on
    request.

    The forward's scratch as its kernels leave it (C Bᵀ of the bf16
    inputs, the inclusive cumsum, the state entering each chunk); then G =
    (e^{cs} dY)ᵀ C, the reverse recurrence from ``gh``, dX = Mᵀ dY + w B Dᵀ
    with the per-head dcs and ddt terms, dCB summed over heads, dC and dB
    with their state sides, the reverse cumsum and dA over the chunks.
    Every product with a computed operand (e^{cs} dY, D, M, dCB, H) takes
    it as a bf16 high part plus remainder, emulated as the product with
    (high + remainder); dY Xᵀ multiplies inputs alone. dx, dB and dC are
    rounded to bf16. Faults: ``state_dx`` False leaves the state side out of
    dX, ``use_gh`` False ignores the final state's gradient, ``da_chunks``
    sums dA over that many chunks alone."""
    bf = lambda t: t.to(torch.bfloat16).float()
    split = lambda t: bf(t) + bf(t - bf(t))
    B, S, nh, hd = x.shape
    nc = S // chunk
    heads = lambda t: t.float().permute(0, 2, 1, 3).reshape(B, nh, nc, chunk,
                                                            -1)
    xs, gys = heads(x), heads(gy)
    dts = dt.float().permute(0, 2, 1).reshape(B, nh, nc, chunk)
    bm = Bm[:, :, 0].float().reshape(B, 1, nc, chunk, -1)
    cm = Cm[:, :, 0].float().reshape(B, 1, nc, chunk, -1)
    cs = torch.cumsum(dts * A[None, :, None, None], -1)
    total = cs[..., -1]
    cb = cm @ bm.transpose(-1, -2)                         # [B, 1, nc, i, j]
    ew = torch.exp(total[..., None] - cs)
    w = ew * dts
    states = split(xs * w[..., None]).transpose(-1, -2) @ bm
    h = torch.zeros(B, nh, hd, bm.shape[-1])
    before = []
    for c in range(nc):
        before.append(h)
        h = h * torch.exp(total[:, :, c])[..., None, None] + states[:, :, c]
    H = torch.stack(before, dim=2)                         # [B, nh, nc, hd, N]
    # B1-B2: the state gradients, backwards over the chunks
    g_in = split(gys * torch.exp(cs)[..., None]).transpose(-1, -2) @ cm
    d = gh.float() if gh is not None and use_gh else torch.zeros_like(h)
    after = [None] * nc
    for c in reversed(range(nc)):
        after[c] = d
        d = g_in[:, :, c] + torch.exp(total[:, :, c])[..., None, None] * d
    D = torch.stack(after, dim=2)
    # B3: dX and the per-head terms of dcs and ddt
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp((cs[..., :, None] - cs[..., None, :])
                                   .masked_fill(~tri, -math.inf)), 0.0)
    lcb = cb * L
    m = lcb * dts[..., None, :]
    v = bm @ split(D).transpose(-1, -2)                    # B_j Dᵀ
    u = (xs * v).sum(-1)
    dx = split(m).transpose(-1, -2) @ gys
    if state_dx:
        dx = dx + w[..., None] * v
    p = gys @ xs.transpose(-1, -2)                         # dY Xᵀ, [i, j]
    z = p * m
    ddt = (p * lcb).sum(-2) + ew * u
    dcs = z.sum(-1) - z.sum(-2) - w * u
    dcs[..., -1] += (w * u).sum(-1) + torch.exp(total) * (D * H).sum((-2, -1))
    # B4-B5: dCB over the heads, dC and dB
    dcb = split((p * L * dts[..., None, :]).sum(1, keepdim=True))
    gyh = gys @ split(H)                                   # dY H
    dC = dcb @ bm + (torch.exp(cs)[..., None] * gyh).sum(1, keepdim=True)
    dcs = dcs + torch.exp(cs) * (cm * gyh).sum(-1)
    dB = (dcb.transpose(-1, -2) @ cm
          + (w[..., None] * (xs @ split(D))).sum(1, keepdim=True))
    # B6-B7: cs = cumsum(dt A)
    da = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
    ddt = ddt + A[None, :, None, None] * da
    parts = (dts * da).sum(-1)                             # [B, nh, nc]
    dA = parts[..., :da_chunks].sum((0, 2))
    back = lambda t: t.reshape(B, -1, S, t.shape[-1]).permute(0, 2, 1, 3)
    return (bf(back(dx)), back(ddt[..., None])[..., 0], dA,
            bf(back(dB)), bf(back(dC)))


def test_chip_backward_tolerance_passes_the_kernel_arithmetic_and_fails_faults():
    """``chip_smoke.py``'s bounds on the backward kernels against the plain
    backward, at mamba2-370m's head geometry with the model's dt and A
    ranges and a final state's gradient: the kernels' own arithmetic stays
    well inside them; the state side of dX left out, the final state's
    gradient ignored, or dA summed over one chunk alone breaks one."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    rng = np.random.default_rng(8)
    B, S, nh, hd, N, chunk = 1, 1024, 4, 64, 128, 256
    bf = lambda a: torch.tensor(a, dtype=torch.float32).to(
        torch.bfloat16).float()
    x, gy = (bf(rng.standard_normal((B, S, nh, hd))) for _ in range(2))
    Bm, Cm = (bf(rng.standard_normal((B, S, 1, N))) for _ in range(2))
    bias = np.log(np.expm1(rng.uniform(1e-3, 1e-1, nh)))
    dt = torch.tensor(np.log1p(np.exp(
        rng.standard_normal((B, S, nh)) * 0.5 + bias)), dtype=torch.float32)
    A = torch.tensor(-rng.uniform(1.0, 16.0, nh), dtype=torch.float32)
    gh = torch.tensor(rng.standard_normal((B, nh, hd, N)), dtype=torch.float32)
    b16 = lambda t: t.to(torch.bfloat16)
    want = ssd.ssd_chunked_bwd(b16(x), dt, A, b16(Bm), b16(Cm), chunk,
                               b16(gy), gh)

    def errors(**fault):
        got = _kernel_bwd_arithmetic(x, dt, A, Bm, Cm, chunk, gy, gh,
                                     **fault)
        return chip_smoke.ssd_bwd_errors(got, want)

    ok = errors()
    for name in chip_smoke.SSD_BWD_GRADS:
        tol = (chip_smoke.SSD_BWD_F32_REL_RMS_TOL if name in ("ddt", "dA")
               else chip_smoke.SSD_BWD_BF16_REL_RMS_TOL)
        assert ok[f"{name}_rel_rms_err"] < tol / 3, ok
    assert chip_smoke.ssd_bwd_ok(ok)
    for fault in ({"state_dx": False}, {"use_gh": False}, {"da_chunks": 1}):
        assert not chip_smoke.ssd_bwd_ok(errors(**fault)), fault


def test_backward_kernels_are_named_apart_from_the_forward():
    """Every ``__global__`` kernel of ``csrc/ssd_scan.cu`` is a forward pass
    (``chip_smoke.SSD_PASSES``) or a backward pass
    (``chip_smoke.SSD_BWD_PASSES``), and no backward name holds
    ``SSD_KERNEL_PREFIX``, by which the profiler's forward time (and the
    benchmark's forward roofline) is summed."""
    sys.path.insert(0, str(REPO))
    import re
    import chip_smoke
    src = (REPO / "src" / "repro_torch" / "csrc" / "ssd_scan.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(",
                       src)
    assert sorted(names) == sorted(chip_smoke.SSD_PASSES
                                   + chip_smoke.SSD_BWD_PASSES)
    assert all(n.startswith(chip_smoke.SSD_BWD_PREFIX)
               and chip_smoke.SSD_KERNEL_PREFIX not in n
               for n in chip_smoke.SSD_BWD_PASSES)
    assert all(n.startswith(chip_smoke.SSD_KERNEL_PREFIX)
               for n in chip_smoke.SSD_PASSES)


def test_backward_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors ``ssd_scan_bwd`` is the plain backward and launches
    nothing, whether called alone or as ``ops.ssd_scan``'s backward;
    FlopCounterMode counts its op by ``ssd_bwd_cost``; on meta tensors
    ``ops.ssd_scan``'s backward recomputes through ``ssd_chunked`` (the
    dry run's count, larger than the rule's); other devices and misshapen
    gradients raise."""
    from torch.utils.flop_counter import FlopCounterMode
    case = CASES["narrow_heads"]
    chunk = case[-1]
    ins = _inputs(case)
    gy, gh = _grads_out(case, 9, True)
    before = (ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches)
    y, h, work = ssd.ssd_scan(*ins, chunk, scratch=True)
    assert work.numel() == 0
    with FlopCounterMode(display=False) as fc:
        got = ssd.ssd_scan_bwd(*ins, chunk, gy, gh, work)
    assert fc.get_total_flops() == ssd.ssd_bwd_cost(
        tuple(ins[0].shape), case[4], chunk)[0]
    want = ssd.ssd_chunked_bwd(*ins, chunk, gy, gh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, h = ops.ssd_scan(*leaves, chunk)
    auto = torch.autograd.grad([y, h], leaves, [gy, gh])
    assert all(torch.equal(g, w) for g, w in zip(auto, want))
    assert (ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches) == before
    meta = [t.to("meta").requires_grad_(True) for t in ins]
    y, _ = ops.ssd_scan(*meta, chunk)
    with FlopCounterMode(display=False) as fc:
        grads = torch.autograd.grad(y, meta, gy.to("meta"))
    assert [(g.device.type, g.shape) for g in grads] == [
        ("meta", t.shape) for t in ins]
    assert fc.get_total_flops() > ssd.ssd_bwd_cost(
        tuple(ins[0].shape), case[4], chunk)[0]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd.ssd_scan_bwd(*(_torch_ref.on_another_device(t) for t in ins),
                         chunk, gy, gh, work)
    with pytest.raises(ValueError, match="gy must"):
        ssd.ssd_scan_bwd(*ins, chunk, gy[:, 1:], gh, work)
    with pytest.raises(ValueError, match="gh must"):
        ssd.ssd_scan_bwd(*ins, chunk, gy, gh[..., 1:], work)


# --- the wrapper -----------------------------------------------------------------

def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    case = CASES["narrow_heads"]
    ins = _inputs(case)
    before = ssd.ssd_scan.launches
    y, h = ssd.ssd_scan(*ins, case[-1])
    y2, h2 = ssd.ssd_chunked(*ins, case[-1])
    assert ssd.ssd_scan.launches == before
    assert torch.equal(y, y2) and torch.equal(h, h2)
    ym, hm = ssd.ssd_scan(*(t.to("meta") for t in ins), case[-1])
    assert (ym.device.type, ym.shape, ym.dtype) == ("meta", y.shape, y.dtype)
    assert (hm.device.type, hm.shape, hm.dtype) == ("meta", h.shape, h.dtype)
    assert ssd.ssd_scan.launches == before
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        ssd.ssd_scan(*(_torch_ref.on_another_device(t) for t in ins), case[-1])
    x, dt, A, Bm, Cm = ins
    with pytest.raises(ValueError, match="n_groups"):
        ssd.ssd_scan(x, dt, A, Bm.expand(-1, -1, 2, -1),
                     Cm.expand(-1, -1, 2, -1), case[-1])
    with pytest.raises(ValueError, match="divisible"):
        ssd.ssd_scan(*ins, 100)
    with pytest.raises(ValueError, match="divisible"):
        ops.ssd_scan(*ins, 100)


# --- the Mamba-2 block ----------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel_path", "chunked"])
def test_mamba_block_matches_reference(use_kernel):
    """The block on reduced mamba2 (d_model 64, d_state 16, head_dim 16,
    chunk 32) in f32, the reference's weights: the kernel path against
    the reference's Pallas path, the chunked one against its jnp path;
    then one decode step from a state (the recurrence, whichever path)
    against the reference's, output and new state."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as ref_reduced
    from repro.models import init_params
    from repro.models.ssm import mamba_block as ref_block
    cfg_r = ref_reduced("mamba2-370m", layers=2, d_model=64, vocab=256)
    cfg_t = get_reduced("mamba2-370m", layers=2, d_model=64, vocab=256)
    assert dataclasses.astuple(cfg_r.ssm) == dataclasses.astuple(cfg_t.ssm)
    tree = init_params(jax.random.PRNGKey(0),
                       dataclasses.replace(cfg_r, dtype="float32"))
    p_ref = jax.tree.map(lambda a: a[0], tree["decoder"]["blocks"]["sub0"]
                         ["ssm"])
    p = {k: torch.tensor(np.asarray(v)) for k, v in p_ref.items()}
    x = np.random.default_rng(3).standard_normal((1, 64, 64)).astype(
        np.float32)
    want, _ = ref_block(p_ref, jnp.asarray(x), cfg_r.ssm,
                        use_kernel=use_kernel)
    got, state = ssm.mamba_block(p, torch.tensor(x), cfg_t.ssm,
                                 use_kernel=use_kernel)
    assert state is None
    _assert_close(got.numpy(), want, torch.float32)
    # the decode branch: one token from a rolling conv window and a state
    from repro.models.ssm import SSMState as RefState
    rng = np.random.default_rng(4)
    s = cfg_t.ssm
    conv_ch = s.d_inner(64) + 2 * s.n_groups * s.d_state
    conv = rng.standard_normal((1, s.conv_width - 1, conv_ch)).astype(
        np.float32)
    h = rng.standard_normal((1, s.n_heads(64), s.headdim,
                             s.d_state)).astype(np.float32)
    x1 = rng.standard_normal((1, 1, 64)).astype(np.float32)
    want1, st_r = ref_block(p_ref, jnp.asarray(x1), cfg_r.ssm,
                            state=RefState(conv=jnp.asarray(conv),
                                           h=jnp.asarray(h)),
                            use_kernel=use_kernel)
    got1, st_t = ssm.mamba_block(p, torch.tensor(x1), cfg_t.ssm,
                                 state=ssm.SSMState(conv=torch.tensor(conv),
                                                    h=torch.tensor(h)),
                                 use_kernel=use_kernel)
    _assert_close(got1.numpy(), want1, torch.float32)
    _assert_close(st_t.conv.numpy(), st_r.conv, torch.float32)
    _assert_close(st_t.h.numpy(), st_r.h, torch.float32)


# --- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", [*CASES, *EDGES])
def test_kernel_matches_plain_on_the_card(name):
    """The CUDA kernel against its plain version in bf16, to the bounds
    ``chip_smoke.py`` uses at the training shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    case = CASES[name] if name in CASES else EDGES[name]
    x, dt, A, Bm, Cm = (t.cuda() for t in _inputs(case, torch.bfloat16))
    before = ssd.ssd_scan.launches
    y, h = ssd.ssd_scan(x, dt, A, Bm, Cm, case[-1])
    y_p, h_p = ssd.ssd_chunked(x, dt, A, Bm, Cm, case[-1])
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    err = chip_smoke.ssd_errors(y, h, y_p, h_p)
    assert chip_smoke.ssd_ok(err), err
    with pytest.raises(ValueError, match="bfloat16"):
        ssd.ssd_scan(x.float(), dt, A, Bm, Cm, case[-1])


@pytest.mark.gpu
def test_kernel_reads_strided_views_on_the_card():
    """x, B and C as the Mamba-2 block hands them over: views into one
    packed [B, S, d_in + 2N] activation, dt a view of a wider one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    B, S, nh, hd, N, chunk = 2, 512, 4, 64, 128, 256
    rng = np.random.default_rng(11)
    packed = torch.tensor(rng.standard_normal((B, S, nh * hd + 2 * N)),
                          dtype=torch.float32).to(torch.bfloat16).cuda()
    x, Bm, Cm = torch.split(packed, [nh * hd, N, N], dim=-1)
    x = x.reshape(B, S, nh, hd)
    Bm, Cm = Bm.reshape(B, S, 1, N), Cm.reshape(B, S, 1, N)
    assert not (x.is_contiguous() or Bm.is_contiguous())
    wide = torch.tensor(np.log1p(np.exp(rng.standard_normal((B, S, 2 * nh)))),
                        dtype=torch.float32).cuda()
    dt = wide[..., nh:]
    A = torch.tensor(-np.exp(rng.standard_normal(nh) * 0.5),
                     dtype=torch.float32).cuda()
    y, h = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk)
    y_p, h_p = ssd.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    err = chip_smoke.ssd_errors(y, h, y_p, h_p)
    assert chip_smoke.ssd_ok(err), err


@pytest.mark.gpu
@pytest.mark.parametrize("with_gh", [False, True], ids=["gh_zero", "gh"])
@pytest.mark.parametrize("name", [*CASES, *EDGES])
def test_backward_kernels_match_plain_on_the_card(name, with_gh):
    """``ops.ssd_scan``'s backward on the card (the backward kernels on the
    forward's scratch) against the plain backward in bf16, to the bounds
    ``chip_smoke.py`` uses; a call launches the forward once and the
    backward once; unsupported input raises rather than falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    case = CASES[name] if name in CASES else EDGES[name]
    chunk = case[-1]
    ins = [t.cuda() for t in _inputs(case, torch.bfloat16)]
    gy, gh = _grads_out(case, 3, with_gh)
    gy = gy.to(torch.bfloat16).cuda()
    gh = None if gh is None else gh.cuda()
    leaves = [t.clone().requires_grad_(True) for t in ins]
    before = (ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches)
    y, h = ops.ssd_scan(*leaves, chunk)
    outs, gouts = ([y, h], [gy, gh]) if with_gh else ([y], [gy])
    got = torch.autograd.grad(outs, leaves, gouts)
    torch.cuda.synchronize()
    assert (ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert [g.dtype for g in got] == [t.dtype for t in ins]
    want = ssd.ssd_chunked_bwd(*ins, chunk, gy, gh)
    err = chip_smoke.ssd_bwd_errors(got, want)
    assert chip_smoke.ssd_bwd_ok(err), err
    _, _, work = ssd.ssd_scan(*ins, chunk, scratch=True)
    with pytest.raises(ValueError, match="scratch"):
        ssd.ssd_scan_bwd(*ins, chunk, gy, gh, work[1:])
    with pytest.raises(ValueError, match="bfloat16"):
        ssd.ssd_scan_bwd(*ins, chunk, gy.float(), gh, work)


@pytest.mark.gpu
def test_backward_kernels_read_strided_views_on_the_card():
    """The backward as the Mamba-2 block drives it: x, B and C views into
    one packed activation, dt a view of a wider one; the output gradient a
    strided view, then a broadcast one (of ``y.sum()``), which the wrapper
    copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    B, S, nh, hd, N, chunk = 2, 512, 4, 64, 128, 256
    rng = np.random.default_rng(12)
    packed = torch.tensor(rng.standard_normal((B, S, nh * hd + 2 * N)),
                          dtype=torch.float32).to(torch.bfloat16).cuda()
    wide = torch.tensor(np.log1p(np.exp(rng.standard_normal((B, S, 2 * nh)))),
                        dtype=torch.float32).cuda()
    A = torch.tensor(-np.exp(rng.standard_normal(nh) * 0.5),
                     dtype=torch.float32).cuda()
    big = torch.tensor(rng.standard_normal((B, S, nh, 2 * hd)),
                       dtype=torch.float32).to(torch.bfloat16).cuda()
    for gy in (big[..., hd:], torch.ones(1, dtype=torch.bfloat16,
                                         device="cuda").expand(B, S, nh, hd)):
        p = packed.clone().requires_grad_(True)
        dtw = wide.clone().requires_grad_(True)
        a = A.clone().requires_grad_(True)
        x, Bm, Cm = torch.split(p, [nh * hd, N, N], dim=-1)
        ins = (x.reshape(B, S, nh, hd), dtw[..., nh:], a,
               Bm.reshape(B, S, 1, N), Cm.reshape(B, S, 1, N))
        y, _ = ops.ssd_scan(*ins, chunk)
        got = torch.autograd.grad(y, ins, gy)
        want = ssd.ssd_chunked_bwd(*(t.detach() for t in ins), chunk, gy,
                                   None)
        err = chip_smoke.ssd_bwd_errors(got, want)
        assert chip_smoke.ssd_bwd_ok(err), err
