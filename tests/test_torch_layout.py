"""The port's sharded layout against the reference's, on both production
meshes, on the CPU.

The reference runs in a child process on 512 forced host devices (as
``launch/dryrun.py`` sets them), its meshes built with
``jax.sharding.Mesh`` (``tests/_torch_ref.py::_child_layout``). For every
arch at full size (abstract: nothing is allocated), under the ``2d``,
``fsdp`` and ``dp`` rules and ``seq_attn_rules("2d")``, on the 16 x 16 and
the 2 x 16 x 16 mesh, each leaf of the parameters, the optimizer state
(``zero_pod``), every shape's batch and the decode cache (``seq_shard``
both ways) has the reference's resolved spec, shard shape, shape and
dtype, the reference's leading group dimension stripped through the
name map that ``models/convert.py`` uses (``params.unstack_leaves``).
``choose_seq_attn`` is the reference's for every cell of ``cells()``.
"""
import json

import numpy as np
import pytest
import torch

import _torch_ref as ref
from repro_torch.configs import ARCHS, SHAPES, cells, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import kvcache as KC
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.optim.adamw import abstract_opt_state
from repro_torch.runtime import pspec as PS
from repro_torch.runtime import steps

MESHES = {"pod1": False, "pod2": True}
PARTS = ("params", "opt", "batch", "cache")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    arrs = ref.run_reference("layout", tmp_path_factory.mktemp("ref")
                             / "layout.npz",
                             host_devices=ref.LAYOUT_DEVICES)
    return json.loads(str(arrs["layout"]))


def _scope(mesh: str, rules: str):
    sizes, names = ref.LAYOUT_MESHES[mesh]
    prod = make_production_mesh(multi_pod=MESHES[mesh])
    assert prod.axis_names == names
    assert tuple(prod.shape.values()) == sizes
    return PS.sharding_scope(prod, PS.seq_attn_rules("2d")
                             if rules == "seq_2d" else rules)


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _leaf(sharding, t: torch.Tensor) -> list:
    return [_spec_json(sharding.spec), list(sharding.shard_shape(t.shape)),
            list(t.shape), str(t.dtype).replace("torch.", "")]


def _strip(leaf: list, _: int) -> list:
    """A stacked leaf as one layer's: the group dimension dropped from
    its spec, shard shape and shape."""
    spec, shard, shape, dtype = leaf
    assert spec[0] is None                  # the group axis never splits
    return [spec[1:], shard[1:], shape[1:], dtype]


def _unstacked(cfg, flat: dict, prefix: str = "") -> dict:
    """The reference's parameter leaves under ``prefix`` in the port's
    naming."""
    return P.unstack_leaves(ref.nest(flat, prefix), cfg, _strip)


def _cache_unstacked(cfg, flat: dict, prefix: str = "") -> dict:
    """The reference's cache leaves under ``prefix`` (``sub{i}/k``,
    stacked over groups) keyed as the port's layers:
    ``decoder.layers.{l}.k``."""
    return P.unstack_leaves({"decoder": {"blocks": ref.nest(flat, prefix)}},
                            cfg, _strip)


def _port_cache(cfg, shardings: list, abstract: list) -> dict:
    return {f"decoder.layers.{i}.{k}": _leaf(shardings[i][k], t)
            for i, sub in enumerate(abstract) for k, t in sub.items()}


def _params(cfg, want):
    ab = P.abstract_params(cfg)
    got = {k: _leaf(s, ab[k]) for k, s in P.param_shardings(cfg).items()}
    return got, _unstacked(cfg, want["params"])


def _opt(cfg, want):
    sh = steps.opt_shardings(cfg)
    ab = abstract_opt_state(P.abstract_params(cfg))
    got = {"step": _leaf(sh.step, ab.step)}
    exp = {"step": want["opt"]["step"]}
    for part in ("master", "m", "v"):
        for k, s in getattr(sh, part).items():
            got[f"{part}.{k}"] = _leaf(s, getattr(ab, part)[k])
        for k, v in _unstacked(cfg, want["opt"], f"{part}/").items():
            exp[f"{part}.{k}"] = v
    return got, exp


def _batch(cfg, want):
    got, exp = {}, {}
    for shape in SHAPES:
        sh, ab = steps.batch_shardings(cfg, shape), M.input_specs(cfg, shape)
        w = want[f"batch|{shape.name}"]
        assert set(sh) == set(ab)
        for k in sh:
            if k == "cache":
                got.update({f"{shape.name}.{n}": v for n, v in _port_cache(
                    cfg, sh[k], ab[k]).items()})
                exp.update({f"{shape.name}.{n}": v for n, v in
                            _cache_unstacked(cfg, w, "cache/").items()})
            else:
                got[f"{shape.name}.{k}"] = _leaf(sh[k], ab[k])
                exp[f"{shape.name}.{k}"] = w[k]
    return got, exp


def _cache(cfg, want):
    dec = SHAPES[2]
    enc = dec.seq_len // 4 if cfg.family == "encdec" else 0
    ab = KC.abstract_cache(cfg, dec.global_batch, dec.seq_len, enc)
    got, exp = {}, {}
    for seq in (False, True):
        axes = KC.cache_logical_axes(cfg, seq_shard=seq)
        sh = [{k: PS.named_sharding(ax[k], shape=sub[k].shape) for k in sub}
              for ax, sub in zip(axes, ab)]
        got.update({f"{seq}.{n}": v
                    for n, v in _port_cache(cfg, sh, ab).items()})
        exp.update({f"{seq}.{n}": v for n, v in _cache_unstacked(
            cfg, want[f"cache|{seq}"]).items()})
    return got, exp


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("rules", ref.LAYOUT_RULES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_layout_matches_reference_leaf_for_leaf(reference, arch, mesh, rules,
                                                part):
    cfg = get_config(arch)
    want = reference[f"{mesh}|{rules}|{arch}"]
    with _scope(mesh, rules):
        got, exp = {"params": _params, "opt": _opt, "batch": _batch,
                    "cache": _cache}[part](cfg, want)
    assert got.keys() == exp.keys()
    bad = {k: (got[k], exp[k]) for k in got if got[k] != exp[k]}
    assert not bad, dict(list(bad.items())[:5])


@pytest.mark.parametrize("rules", ref.LAYOUT_RULES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_choose_seq_attn_matches_reference_on_every_cell(reference, mesh,
                                                         rules):
    with _scope(mesh, rules):
        got = {f"{a}|{sh.name}": steps.choose_seq_attn(get_config(a), sh)
               for a, sh, _ in cells()}
    assert got == reference[f"{mesh}|{rules}|choose"]


def test_choose_seq_attn_takes_the_few_kv_head_models():
    """Under the 2d rules on a 16-wide model axis, train and prefill
    cells of models with 8 or fewer KV heads go sequence-parallel."""
    with _scope("pod1", "2d"):
        chosen = {a for a, sh, _ in cells()
                  if steps.choose_seq_attn(get_config(a), sh)}
        decode = [steps.choose_seq_attn(get_config(a), sh)
                  for a, sh, _ in cells() if sh.kind == "decode"]
    assert {"gemma3-12b", "arctic-480b", "kimi-k2-1t-a32b",
            "jamba-v0.1-52b"} <= chosen
    assert not any(decode)
    assert not steps.choose_seq_attn(get_config("gemma3-12b"), SHAPES[0])


def test_logical_constraint_returns_x_itself():
    x = torch.randn(4, 6, 8)
    assert PS.logical_constraint(x, ("batch", None, "heads")) is x
    with _scope("pod2", "2d"):
        assert PS.logical_constraint(x, ("batch", None, "heads")) is x
    with PS.sharding_scope(PS.HostMesh([["cpu", "cpu"]], ("data", "model")),
                           "2d"):
        y = PS.logical_constraint(x, ("batch", None, "heads"))
    assert y is x and torch.equal(y, x.clone())


def test_named_sharding_is_none_outside_a_mesh_and_resolves_inside():
    assert PS.named_sharding(("batch", None)) is None
    with _scope("pod2", "2d"):
        ns = PS.named_sharding(("batch", "vocab"), shape=(64, 48))
        assert ns.mesh is PS.active_mesh()
    assert ns.spec == (("pod", "data"), "model")
    assert ns.shard_shape((64, 48)) == (2, 3)
    with pytest.raises(ValueError, match="does not split"):
        ns.shard_shape((64, 40))
    with pytest.raises(ValueError, match="more entries"):
        ns.shard_shape((64,))


def test_production_meshes_hold_no_devices():
    for multi, n in ((False, 256), (True, 512)):
        mesh = make_production_mesh(multi_pod=multi)
        assert not isinstance(mesh, PS.HostMesh)
        assert int(np.prod(list(mesh.shape.values()))) == n


def test_abstract_trees_allocate_nothing():
    cfg = get_config("kimi-k2-1t-a32b")
    ab = P.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in ab.values())
    assert sum(t.numel() for t in ab.values()) == P.count_params(cfg)
    assert set(ab) == set(P.param_logical_axes(cfg))
    opt = abstract_opt_state(ab)
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               for t in opt.master.values())
    cache = M.input_specs(cfg, SHAPES[2])["cache"]
    assert len(cache) == cfg.n_layers
    assert all(t.device.type == "meta" for c in cache for t in c.values())


def test_prefill_and_serve_steps_are_the_model_api():
    """``make_prefill_step`` and ``make_serve_step`` run the model API on
    a batch of ``input_specs``' layout: the same logits and cache."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import RunConfig, ShapeConfig
    cfg = dataclasses.replace(get_reduced("gemma3-12b", layers=2),
                              dtype="float32")
    run = RunConfig(arch="g", attn_impl="naive", remat="none")
    model = M.build_model(cfg, seed=0, device="cpu")
    batch = M.make_batch(cfg, ShapeConfig("p", 16, 2, "prefill"),
                         torch.Generator().manual_seed(1))
    assert set(batch) == set(M.input_specs(cfg, ShapeConfig("p", 16, 2,
                                                             "prefill")))
    got, cache = steps.make_prefill_step(cfg, run, 20)(model, batch)
    want, want_cache = M.prefill(model, run, batch["tokens"], 20)
    assert torch.equal(got, want)
    tok = got.argmax(-1)[:, None]
    got, _ = steps.make_serve_step(cfg, run)(model, tok, cache, 16)
    want, _ = M.decode_step(model, run, tok, want_cache, 16)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="attn_impl"):
        steps.make_prefill_step(cfg, dataclasses.replace(
            run, attn_impl="pallas"), 20)
