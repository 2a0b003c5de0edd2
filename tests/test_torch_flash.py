"""The port's flash attention against the reference's: the plain version
against ``repro.kernels.ref.flash_attention_ref`` and against the Pallas
kernel (``repro.kernels.ops.flash_attention``, interpret mode, as
``tests/test_kernels.py`` runs it), the wrapper's dispatch, the tolerance
``chip_smoke.py`` holds the CUDA kernel to, and — on a GPU — the kernel
against its plain version.

f32 inputs are unit normals made with numpy; 1e-5 absolute covers the f32
sum-order differences of two softmax implementations over <= 300 keys.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ref
from repro_torch.kernels import flash_attention as fa

REPO = Path(__file__).resolve().parents[1]

# (B, T, Hq, Hkv, d, window): all causal
CASES = {
    "causal": (2, 256, 4, 4, 32, None),
    "window": (1, 200, 2, 2, 64, 64),
    "gqa_2to1": (2, 256, 4, 2, 32, None),
    "ragged_gqa_window": (1, 300, 4, 2, 16, 100),
}

# edges of the kernel's 128-row q tiles and 64-key kv tiles, on the card
# only: T not a multiple of 128, T shorter than one tile, window 1, a
# window past T, gemma3-12b's GQA 16:8 at head_dim 240, three 64-column
# chunks of head_dim, internvl2-1b's prefill (GQA 14:2, a group of 7,
# at head_dim 64, one chunk), jamba's (32:8 at 128, two whole chunks) and
# kimi-k2's (64:8 at 112, a partial second chunk), and both head_dims with
# a window and a ragged T
EDGES = {
    "gqa_14to2_d64": (4, 2048, 14, 2, 64, None),
    "t_130": (1, 130, 2, 2, 64, None),
    "t_40_gqa": (2, 40, 2, 1, 32, None),
    "window_1": (1, 200, 2, 2, 64, 1),
    "window_past_t": (1, 200, 2, 2, 64, 256),
    "gqa_16to8_d240": (1, 300, 16, 8, 240, 100),
    "d192_ragged": (1, 150, 2, 2, 192, None),
    "gqa_32to8_d128": (4, 2048, 32, 8, 128, None),
    "gqa_64to8_d112": (4, 2048, 64, 8, 112, None),
    "d128_window": (1, 300, 4, 1, 128, 100),
    "d112_ragged": (1, 150, 8, 1, 112, None),
}


def _inputs(case, dtype=torch.float32, seed=0):
    B, T, Hq, Hkv, d, _ = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(dtype) for s in ((B, T, Hq, d), (B, T, Hkv, d),
                                    (B, T, Hkv, d)))
    return q, k, v


def _jax_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref
    return jnp, ops, ref


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jnp_oracle(name):
    jnp, _, ref = _jax_reference()
    q, k, v = _inputs(CASES[name])
    window = CASES[name][-1]
    want = ref.flash_attention_ref(
        *(jnp.asarray(x.numpy().transpose(0, 2, 1, 3)) for x in (q, k, v)),
        causal=True, window=window)
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1, 3),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_kernel(name):
    jnp, ops, _ = _jax_reference()
    q, k, v = _inputs(CASES[name])
    window = CASES[name][-1]
    want = ops.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               True, window)
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_reference_pallas_attends_its_padding_when_not_causal():
    """Reference caveat: ``ops.py`` pads T=100 to 128 and the kernel masks
    by the padded length, so non-causal queries attend 28 zero keys. The
    port masks by the true length and matches the jnp oracle."""
    jnp, ops, ref = _jax_reference()
    q, k, v = _inputs((1, 100, 2, 2, 16, None), seed=3)
    got = fa.flash_attention(q, k, v, causal=False)
    pallas = np.asarray(ops.flash_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), False, None))
    oracle = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(x.numpy().transpose(0, 2, 1, 3)) for x in (q, k, v)),
        causal=False)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=0)
    assert np.abs(pallas - oracle).max() > 0.05


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    q, k, v = _inputs(CASES["gqa_2to1"])
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=None)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(
        got, fa.flash_attention_plain(q, k, v, causal=True), rtol=0, atol=0)
    meta = fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert (meta.device.type, meta.shape, meta.dtype) == (
        "meta", q.shape, q.dtype)
    assert fa.flash_attention.launches == before
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        fa.flash_attention(*(_torch_ref.on_another_device(t) for t in (q, k, v)))
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)


@pytest.mark.parametrize("name", ["gqa_2to1", "ragged_gqa_window"])
def test_flash_gradients_match_jax_grad(name):
    """d/d(q, k, v) of <o, g> through the port's ``ops.flash_attention``
    (forward through the wrapper, backward recomputed through the plain
    version) against ``jax.grad`` through the reference's
    ``ops.flash_attention`` (backward through ``flash_attention_ref``),
    causal, f32. Relative to each gradient's largest value, 1e-5 covers
    f32 sum order over <= 300 keys."""
    import jax
    from repro_torch.kernels import ops as port_ops
    jnp, ops, _ = _jax_reference()
    case = CASES[name]
    window = case[-1]
    q, k, v = _inputs(case, seed=4)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda q, k, v: (ops.flash_attention(q, k, v, True,
                                                         window) * g).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(x.numpy())
                                         for x in (q, k, v)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = fa.flash_attention.launches
    (port_ops.flash_attention(*leaves, True, window)
     * torch.tensor(g)).sum().backward()
    assert fa.flash_attention.launches == before
    for x, w in zip(leaves, want):
        w = np.asarray(w)
        assert np.abs(x.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# --- the tolerance chip_smoke.py holds the CUDA kernel to --------------------

def _kernel_arithmetic(q, k, v, window, *, causal=True, mask_length=True,
                       split_p=True, bf16_acc=False, block=64):
    """The CUDA kernel's arithmetic in torch ([B, H, T, d], one kv head
    per q head), as one consumer warpgroup runs it: S = Q K^T over 64-key
    tiles in f32 (wgmma accumulates in f32), the keys past T zero-filled as
    TMA fills them, scaled to log2 units and masked (by the true length,
    or not with ``mask_length=False``: the reference's Pallas padding
    fault), online softmax with ``exp2``, the accumulator rescaled by the
    correction and then P V added as two products, P's bf16 high part and
    its bf16 remainder (``split_p``), or as one bf16 product (the usual
    flash design); the accumulator optionally kept in bf16; O / l rounded
    to bf16."""
    def bf(x):
        return x.to(torch.bfloat16).float()
    B, H, T, d = q.shape
    pad = -T % block
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    scale_log2 = torch.tensor(1.0 / math.sqrt(d)
                              * 1.4426950408889634).float()
    i = torch.arange(T)[:, None]
    j = torch.arange(T + pad)[None, :]
    mask = (j < (T if mask_length else T + pad)).expand(T, -1)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & ((i - j) < window)
    m = torch.full((B, H, T), -math.inf)
    l = torch.zeros(B, H, T)
    acc = torch.zeros(B, H, T, d)
    for k0 in range(0, T + pad, block):
        s = (q @ k[:, :, k0:k0 + block].transpose(-1, -2)) * scale_log2
        s = s.masked_fill(~mask[:, k0:k0 + block], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        ref = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp2(s - ref[..., None])
        corr = torch.exp2(m - ref)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None]
        hi = bf(p)
        acc = acc + hi @ v[:, :, k0:k0 + block]
        if split_p:
            acc = acc + bf(p - hi) @ v[:, :, k0:k0 + block]
        if bf16_acc:
            acc = bf(acc)
        m = m_new
    return bf(acc / l[..., None])


def test_chip_tolerance_passes_the_kernel_arithmetic_and_fails_faults():
    """``chip_smoke.py``'s bound on the kernel's relative RMS error against
    its plain version: the kernel's own arithmetic stays well inside it;
    P rounded to one bf16, an accumulator in bf16, or a dropped window
    mask break it (1024 tokens, head_dim 240, window 512)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 1024, 240)),
                            dtype=torch.float32)
               .to(torch.bfloat16).float() for _ in range(3))
    window = 512
    plain = fa.flash_attention_plain(
        *(x.transpose(1, 2) for x in (q, k, v)), causal=True,
        window=window).transpose(1, 2).to(torch.bfloat16).float()

    def rel_rms(x):
        return float((x - plain).norm() / plain.norm())

    tol = chip_smoke.FLASH_REL_RMS_TOL
    assert rel_rms(_kernel_arithmetic(q, k, v, window)) < tol / 3
    assert rel_rms(_kernel_arithmetic(q, k, v, window, split_p=False)) > tol
    assert rel_rms(_kernel_arithmetic(q, k, v, window, bf16_acc=True)) > tol
    assert rel_rms(_kernel_arithmetic(q, k, v, None)) > tol


def test_chip_tolerance_holds_non_causal_ragged_at_head_dim_64():
    """The same bound at seamless-m4t-medium's encoder (non-causal,
    head_dim 64) over a ragged 500 keys, 12 short of a whole tile: the
    kernel's arithmetic stays inside it; attending the zero-filled keys
    past T (the reference Pallas kernel's padding fault), P rounded to one
    bf16, or an accumulator in bf16 break it."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    rng = np.random.default_rng(8)
    q, k, v = (torch.tensor(rng.standard_normal((1, 4, 500, 64)),
                            dtype=torch.float32)
               .to(torch.bfloat16).float() for _ in range(3))
    plain = fa.flash_attention_plain(
        *(x.transpose(1, 2) for x in (q, k, v)), causal=False
    ).transpose(1, 2).to(torch.bfloat16).float()

    def rel_rms(**kw):
        got = _kernel_arithmetic(q, k, v, None, causal=False, **kw)
        return float((got - plain).norm() / plain.norm())

    tol = chip_smoke.FLASH_REL_RMS_TOL
    assert rel_rms() < tol / 3
    assert rel_rms(mask_length=False) > tol
    assert rel_rms(split_p=False) > tol
    assert rel_rms(bf16_acc=True) > tol


# --- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", [*CASES, *EDGES])
def test_kernel_matches_plain_on_the_card(name):
    """The CUDA kernel against its plain version in bf16, to the bound
    ``chip_smoke.py`` uses at the serving shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    case = CASES[name] if name in CASES else EDGES[name]
    q, k, v = (x.cuda() for x in _inputs(case, torch.bfloat16))
    window = case[-1]
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    err = chip_smoke.flash_errors(got, want)
    assert err["rel_rms_err"] <= chip_smoke.FLASH_REL_RMS_TOL, err
    assert err["max_abs_err"] <= err["max_abs_tol"], err
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float())



@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 50], ids=["full", "window_50"])
def test_kernel_non_causal_and_shorter_queries_on_the_card(window):
    """Without the causal mask every kv tile is visited (and with a window
    only those it reaches), for T = S and for 64 queries over 200 keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    rng = np.random.default_rng(9)
    for T, S in ((200, 200), (64, 200)):
        q = torch.tensor(rng.standard_normal((2, T, 4, 64)),
                         dtype=torch.float32).to(torch.bfloat16).cuda()
        k, v = (torch.tensor(rng.standard_normal((2, S, 2, 64)),
                             dtype=torch.float32).to(torch.bfloat16).cuda()
                for _ in range(2))
        got = fa.flash_attention(q, k, v, causal=False, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=False, window=window)
        torch.cuda.synchronize()
        err = chip_smoke.flash_errors(got, want)
        assert err["rel_rms_err"] <= chip_smoke.FLASH_REL_RMS_TOL, (T, S, err)
        assert err["max_abs_err"] <= err["max_abs_tol"], (T, S, err)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [512, 500], ids=["t_512", "ragged_500"])
def test_kernel_non_causal_head_dim_64_on_the_card(T):
    """seamless-m4t-medium's encoder attention: 4 x T frames, 16 heads of
    64, non-causal; at T = 500 the last kv tile is masked by the true
    length, not attended as zero keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    q, k, v = (x.cuda() for x in _inputs((4, T, 16, 16, 64, None),
                                         torch.bfloat16, seed=T))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    err = chip_smoke.flash_errors(got, want)
    assert err["rel_rms_err"] <= chip_smoke.FLASH_REL_RMS_TOL, err
    assert err["max_abs_err"] <= err["max_abs_tol"], err


def test_ptxas_usage_reads_each_kernel_instance():
    """``chip_smoke.ptxas_usage`` picks the registers, spills and static
    shared memory of the kernels whose mangled name matches, from the
    ``-Xptxas -v`` log that ``_build.build`` keeps beside each library."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi4EEEv14CUtensorMap_st' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111ssd_scan_cbEPK13__nv_bfloat16' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 73 registers, used 1 barriers, 34816 bytes "
        "smem, 400 bytes cmem[0]",
    ])
    flash = chip_smoke.ptxas_usage(log, chip_smoke.FLASH_KERNEL)
    assert list(flash.values()) == [{"spill_bytes": 12, "registers": 168,
                                     "static_smem_bytes": 0}]
    ssd_use = chip_smoke.ptxas_usage(log, chip_smoke.SSD_KERNEL_PREFIX)
    assert list(ssd_use.values()) == [{"spill_bytes": 0, "registers": 73,
                                       "static_smem_bytes": 34816}]
    assert not any(w in name for name in (chip_smoke.FLASH_KERNEL,
                                          *chip_smoke.SSD_PASSES)
                   for w in chip_smoke.GEMM_NAMES)
