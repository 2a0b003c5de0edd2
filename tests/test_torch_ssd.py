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
