"""The port's model stack against the reference, piece by piece: the config
copies field for field, the cluster copy, the parameter spec tree,
``rms_norm``, ``apply_rope``, ``_sdpa`` / ``_blockwise_sdpa``,
``ring_positions`` and ``params_from_jax``. Inputs are made with numpy
and handed to both; f32 throughout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref
from repro import configs as rcfg
from repro.cluster import topology as rtopo
from repro.configs import base as rbase
from repro.models import kvcache as rkv
from repro.models import layers as rl
from repro.models import model as rmodel
from repro.models import params as rp
from repro_torch import configs as tcfg
from repro_torch.cluster import topology as ttopo
from repro_torch.configs import base as tbase
from repro_torch.models import convert, kvcache as tkv, layers as tl
from repro_torch.models import model as tmodel
from repro_torch.models import params as tp


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", rcfg.ARCHS)
def test_configs_equal_field_for_field(arch):
    assert tcfg.ARCHS == rcfg.ARCHS
    assert _as_dict(tcfg.get_config(arch)) == _as_dict(rcfg.get_config(arch))
    for kw in ({}, {"layers": 4}, {"layers": 6, "d_model": 48, "vocab": 128}):
        assert _as_dict(tcfg.get_reduced(arch, **kw)) == \
            _as_dict(rcfg.get_reduced(arch, **kw))
    assert tcfg.get_config(arch).param_counts() == \
        rcfg.get_config(arch).param_counts()


def test_shapes_and_run_config_equal():
    assert [_fields(s) for s in tbase.SHAPES] == \
        [_fields(s) for s in rbase.SHAPES]
    assert [(f.name, f.default) for f in dataclasses.fields(tbase.RunConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(rbase.RunConfig)]
    assert [(a, _fields(s), skip) for a, s, skip in
            tcfg.cells(include_skips=True)] == \
        [(a, _fields(s), skip) for a, s, skip in
         rcfg.cells(include_skips=True)]


def test_cluster_copy_differs_only_in_the_chip_figures():
    """Sites, zones, pods and replicas as the reference's; each pod's chip
    is an H100 (989e12 bf16 FLOP/s, 80 GB) instead of a TPU."""
    for name in ("default_cluster", "paper_testbed"):
        got, want = getattr(ttopo, name)(), getattr(rtopo, name)()
        assert list(got.sites) == list(want.sites)
        for s in want.sites:
            g, w = got.sites[s], want.sites[s]
            assert (g.zone, g.storage_replicas, g.host_profile,
                    g.dcn_gbps, g.n_chips) == \
                (w.zone, w.storage_replicas, w.host_profile, w.dcn_gbps,
                 w.n_chips)
            for gp, wp in zip(g.pods, w.pods):
                assert (gp.name, gp.site, gp.n_chips, gp.mesh_shape) == \
                    (wp.name, wp.site, wp.n_chips, wp.mesh_shape)
                assert (gp.chip_peak_flops, gp.chip_hbm_gb) == (989e12, 80.0)
        assert [_fields(f) for f in got.ftns()] == \
            [_fields(f) for f in want.ftns()]


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen1.5-32b",
                                  "jamba-v0.1-52b", "kimi-k2-1t-a32b",
                                  "arctic-480b"])
def test_param_spec_tree_equal(arch):
    cfg_t, cfg_r = tcfg.get_config(arch), rcfg.get_config(arch)
    got = dict(tp.tree_leaves(tp.param_spec_tree(cfg_t)))
    want = jax.tree_util.tree_flatten_with_path(
        rp.param_spec_tree(cfg_r), is_leaf=lambda s: isinstance(
            s, rp.ParamSpec))[0]
    want = {tuple(k.key for k in path): s for path, s in want}
    assert list(got) == list(want)             # same flattening order
    for path, s in want.items():
        assert dataclasses.asdict(got[path]) == dataclasses.asdict(s), path
    assert tp.count_params(cfg_t) == rp.count_params(cfg_r)
    assert tp.block_specs(cfg_t) == tuple(
        tp.SubLayerSpec(**dataclasses.asdict(s))
        for s in rp.block_specs(cfg_r))


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm_matches():
    x = _rng().standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = _rng(1).standard_normal(64).astype(np.float32) * 0.1
    got = tl.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6)
    want = rl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("theta,head_dim", [(1e6, 240), (1e4, 16)])
def test_apply_rope_matches_at_serving_positions(theta, head_dim):
    """Positions up to 2080 (gemma3-12b's prefill plus decode), split
    halves; torch's and XLA's f32 cos/sin differ by ulps of angles up to
    2080 rad, so 2e-5 absolute on unit-normal inputs."""
    x = _rng(2).standard_normal((2, 2081, 2, head_dim)).astype(np.float32)
    pos = np.arange(2081)
    got = tl.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    want = rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    pos_b = np.stack([pos[:7], pos[100:107]])
    got = tl.apply_rope(torch.tensor(x[:, :7]), torch.tensor(pos_b), theta)
    want = rl.apply_rope(jnp.asarray(x[:, :7]), jnp.asarray(pos_b), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_sdpa_and_blockwise_match(window):
    """Naive and blockwise attention over a cache with empty slots (-1),
    GQA 2:1; 1e-5 absolute covers f32 sum order."""
    B, T, S, nq, nkv, h = 2, 5, 70, 4, 2, 16
    r = _rng(3)
    q = r.standard_normal((B, T, nq, h)).astype(np.float32)
    k = r.standard_normal((B, S, nkv, h)).astype(np.float32)
    v = r.standard_normal((B, S, nkv, h)).astype(np.float32)
    q_pos = np.arange(60, 65)
    kv_pos = np.where(np.arange(S) < 66, np.arange(S), -1)
    scale = 1.0 / np.sqrt(h)
    mask_t = tl._mask(torch.tensor(q_pos), torch.tensor(kv_pos), True, window)
    mask_r = rl._mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), True, window)
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_r))
    T_ = [torch.tensor(a) for a in (q, k, v)]
    J_ = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        tl._sdpa(*T_, mask_t, scale).numpy(),
        np.asarray(rl._sdpa(*J_, mask_r, scale)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tl._blockwise_sdpa(*T_, torch.tensor(q_pos), torch.tensor(kv_pos),
                           True, window, scale, 32).numpy(),
        np.asarray(rl._blockwise_sdpa(*J_, jnp.asarray(q_pos),
                                      jnp.asarray(kv_pos), True, window,
                                      scale, 32)), atol=1e-5, rtol=0)


def test_ring_positions_match():
    for size in (1, 7, 16):
        for window in (False, True):
            for cur in range(0, 2 * size + 2):
                got = tkv.ring_positions(cur, size, window)
                want = rkv.ring_positions(jnp.asarray(cur), size, window)
                assert np.array_equal(got.numpy(), np.asarray(want)), \
                    (size, window, cur)


def test_params_from_jax_unstacks_groups_in_layer_order():
    """gemma3-12b reduced to 4 layers in 2 groups of period 2: layer
    g * 2 + i holds the reference's blocks["sub{i}"][...][g]; values,
    shapes and dtypes unchanged (f32 and bf16)."""
    for dtype in ("float32", "bfloat16"):
        cfg_r = dataclasses.replace(rcfg.get_reduced("gemma3-12b", layers=4),
                                    dtype=dtype)
        cfg_t = dataclasses.replace(tcfg.get_reduced("gemma3-12b", layers=4),
                                    dtype=dtype)
        tree = jax.tree.map(np.asarray,
                            rp.init_params(jax.random.PRNGKey(0), cfg_r))
        sd = convert.params_from_jax(tree, cfg_t)
        period = tp.block_period(cfg_t)
        assert period == 2 and cfg_t.n_layers == 4
        blocks = tree["decoder"]["blocks"]
        for g in range(2):
            for i in range(period):
                want = blocks[f"sub{i}"]["attn"]["wqkv"][g].astype(np.float32)
                got = sd[f"decoder.layers.{g * period + i}.attn.wqkv"]
                assert got.dtype == tp.torch_dtype(dtype)
                np.testing.assert_array_equal(got.float().numpy(), want)
        n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
        assert sum(t.numel() for t in sd.values()) == n
        assert set(sd) >= {"embed.tok", "lm_head", "decoder.norm",
                           "decoder.layers.3.ffn.wg"}


def test_port_init_follows_the_spec_distributions():
    """Same tree and shapes as the reference's init; normals at
    min(0.02, fan_in^-1/2), norms at zero."""
    cfg = tcfg.get_reduced("gemma3-12b", layers=4)
    tree = tp.init_params(cfg, seed=0)
    ref_tree = rp.init_params(jax.random.PRNGKey(0),
                              rcfg.get_reduced("gemma3-12b", layers=4))
    flat = dict(tp.tree_leaves(tree))
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        got = flat[tuple(k.key for k in path)]
        assert tuple(got.shape) == leaf.shape
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype)
    wu = flat[("decoder", "blocks", "sub0", "ffn", "wu")].float()
    assert abs(float(wu.std()) - min(0.02, 64 ** -0.5)) < 1e-3
    assert float(flat[("decoder", "norm")].abs().max()) == 0.0
    again = tp.init_params(cfg, seed=0)
    assert torch.equal(again["embed"]["tok"], tree["embed"]["tok"])


@pytest.mark.parametrize("init_slice", [tp.INIT_SLICE, 64])
def test_init_leaf_slices_draw_the_whole_leaf_stream(monkeypatch,
                                                     init_slice):
    """A normal leaf drawn in slices of its flat view (four of 64 here)
    holds the values of one whole f32 draw, scaled and cast once."""
    monkeypatch.setattr(tp, "INIT_SLICE", init_slice)
    cfg = tcfg.get_reduced("gemma3-12b", layers=2)
    spec = tp.ParamSpec((8, 32), (None, None), scale=0.02)
    got = tp._init_leaf(spec, cfg, torch.Generator().manual_seed(5),
                        torch.device("cpu"))
    whole = torch.randn((8, 32), dtype=torch.float32,
                        generator=torch.Generator().manual_seed(5))
    assert got.dtype == tp.torch_dtype(cfg.dtype)
    assert torch.equal(got, whole.mul_(min(0.02, 8 ** -0.5)).to(got.dtype))


def test_embed_and_unembed_match_in_bf16():
    """bf16 rounds sqrt(d_model) before the multiply (6.9375 for
    sqrt(48); 62.0 for gemma3-12b's sqrt(3840)), as the reference's
    ``jnp.asarray(d ** 0.5, x.dtype)`` does: embeddings agree bit for
    bit."""
    cfg_r = rcfg.get_reduced("gemma3-12b", layers=2, d_model=48)
    cfg_t = tcfg.get_reduced("gemma3-12b", layers=2, d_model=48)
    params = rp.init_params(jax.random.PRNGKey(0), cfg_r)
    model = tmodel.Transformer(cfg_t, convert.params_from_jax(
        jax.tree.map(np.asarray, params), cfg_t))
    toks = _rng(4).integers(0, 255, (2, 9))
    got = tmodel.embed(model, torch.as_tensor(toks))
    want = rmodel.embed(params, cfg_r, jnp.asarray(toks))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_allclose(
        tmodel.unembed(model, got).float().numpy(),
        np.asarray(rmodel.unembed(params, cfg_r, want), np.float32),
        rtol=2e-2, atol=2e-2)
    assert float(torch.tensor(3840 ** 0.5, dtype=torch.bfloat16)) == 62.0
