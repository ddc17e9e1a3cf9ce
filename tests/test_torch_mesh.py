"""The port's mesh planner and logical-axis rules (``kubeflow_tpu_torch/
parallel/{mesh,sharding}.py``) against the reference's, in one process.

- ``plan_mesh`` over a table of axes and slice counts: the same axes, ICI
  and DCN split, or the same ``MeshPlanError`` message;
- ``rules_for_mesh`` on jax meshes of the conftest's virtual devices, with
  and without overrides;
- ``param_shardings``: every port parameter of ``tiny()`` (dense and MoE)
  gets, dim for dim, the mesh axes the reference's ``param_shardings``
  gives its leaf (``models/convert.py``'s paths; the stacked layer dim is
  the reference's extra leading dim);
- ``reshard_plan`` for ``tiny()`` from ``{"fsdp": 2}`` to ``{"model": 2}``:
  the reference's entries, and its error for an illegal degree;
- what the layout cannot take raises: a ``seq`` axis without ring
  attention, a stack the pipeline stages do not divide, and a mesh larger
  than the job's processes (``plan_mesh``'s ``MeshPlanError``; on a
  one-rank gloo group ``build_mesh``'s, naming ROADMAP A13, a ``seq``
  mesh of two on one rank too);
- ``shard_model`` lays out what it once refused, on a mesh of fake axes
  over the one-rank group: LoRA and int8 weights under ``model`` (every
  kernel, scale and adapter factor sliced as its logical axes say),
  the capacity MoE dispatch under ``expert``, and FSDP2 beside
  ``pipeline`` (one FSDP2 unit at the root, the stage gathered whole);
- the ``Trainer`` on a one-rank ``fsdp`` mesh (FSDP2 over one rank, as a
  job with one card per process runs it) takes the unwrapped model's
  steps, with AdamW and with Adafactor;
- ``Llama.init_streamed``, the module-at-a-time init a sharded trainer
  draws from, gives ``init_weights``' values exactly.

torch and the port are imported inside the tests.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.parallel import mesh as ref_mesh
from kubeflow_tpu.parallel import sharding as ref_shard


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.parallel import mesh, sharding

    torch.set_num_threads(1)
    return types.SimpleNamespace(torch=torch, convert=convert, llama=llama,
                                 mesh=mesh, sharding=sharding)


PLANS = [
    ({"data": 8}, None, 1),
    ({"fsdp": 2, "model": 4}, 8, 1),
    ({"model": 2, "fsdp": 2, "data": 2}, 8, 1),
    ({"expert": 2, "data": 2, "fsdp": 1}, 4, 1),
    ({"data": 1}, 1, 1),
    ({}, None, 1),
    ({"pipeline": 2, "fsdp": 4}, 8, 2),
    ({"data": 4, "fsdp": 2}, 8, 2),
    ({"replica": 2, "data": 2, "model": 2}, 8, 4),
    ({"fsdp": 4}, 8, 1),                 # device count mismatch
    ({"model": 4}, 4, 2),                # model over DCN
    ({"data": 3, "fsdp": 2}, 6, 4),      # slices do not factor
    ({"tensor": 2}, None, 1),            # unknown axis
]


@pytest.mark.parametrize("axes,devices,slices", PLANS,
                         ids=[f"plan{i}" for i in range(len(PLANS))])
def test_plan_mesh_matches_reference(axes, devices, slices):
    pt = _port()
    try:
        want = ref_mesh.plan_mesh(axes, devices, slices)
    except ref_mesh.MeshPlanError as e:
        with pytest.raises(pt.mesh.MeshPlanError) as got:
            pt.mesh.plan_mesh(axes, devices, slices)
        assert str(got.value) == str(e)
        return
    got = pt.mesh.plan_mesh(axes, devices, slices)
    assert (got.axes, got.ici_axes, got.dcn_axes) == (
        want.axes, want.ici_axes, want.dcn_axes)
    assert (got.axis_names, got.shape, got.num_devices, got.batch_degree) \
        == (want.axis_names, want.shape, want.num_devices, want.batch_degree)


@pytest.mark.parametrize("axes,slices", [
    ({"fsdp": 2, "model": 4}, 1), ({"data": 4, "fsdp": 2}, 2),
    ({"replica": 2, "data": 2, "model": 2}, 4),
    ({"pipeline": 2, "fsdp": 2, "model": 2}, 2)],
    ids=["ici", "data_dcn", "replica_data_dcn", "pipeline_dcn"])
def test_rank_layout_matches_reference_devices(axes, slices):
    """Rank r is device r: the port's rank array is the reference's device
    array (its by-hand DCN-outermost layout for devices without a
    ``slice_index``)."""
    pt = _port()
    want = ref_mesh.build_mesh(axes, devices=jax.devices()[:8],
                               num_slices=slices)
    ids = np.vectorize(lambda d: d.id)(want.devices).tolist()
    plan = pt.mesh.plan_mesh(axes, 8, slices)
    assert pt.mesh.rank_layout(plan) == ids
    assert plan.axis_names == tuple(want.axis_names)


def test_constants_match_reference():
    pt = _port()
    assert pt.mesh.AXIS_ORDER == ref_mesh.AXIS_ORDER
    assert pt.mesh.DCN_TOLERANT_AXES == ref_mesh.DCN_TOLERANT_AXES
    assert pt.mesh.BATCH_AXES == ref_mesh.BATCH_AXES
    assert pt.sharding.LOGICAL_RULES == ref_shard.LOGICAL_RULES


MESHES = [{"data": 8}, {"fsdp": 2, "model": 4}, {"expert": 2, "data": 4},
          {"replica": 2, "fsdp": 2, "model": 2}]
OVERRIDES = [None, (("embed", None), ("batch", ("data", "fsdp")),
                    ("mlp", ("model", "seq")))]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=["rules", "overrides"])
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "_".join(a))
def test_rules_for_mesh_matches_reference(axes, overrides):
    pt = _port()
    mesh = ref_mesh.build_mesh(axes, devices=jax.devices()[:8])
    assert pt.sharding.rules_for_mesh(mesh, overrides) == \
        ref_shard.rules_for_mesh(mesh, overrides)
    # the port's planned mesh and axis dict give the same table
    assert pt.sharding.rules_for_mesh(pt.mesh.plan_mesh(axes), overrides) \
        == pt.sharding.rules_for_mesh(axes, overrides)


def _ref_specs(cfg, axes):
    """{tree path: PartitionSpec entries} of the reference's tiny on a
    jax mesh of ``axes``."""
    from flax import traverse_util

    mesh = ref_mesh.build_mesh(axes, devices=jax.devices()[:int(np.prod(
        list(axes.values())))])
    model = ref_llama.Llama(cfg)
    boxed = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.ones((1, 8), np.int32)))
    shardings = ref_shard.param_shardings(boxed, mesh)
    flat = traverse_util.flatten_dict(shardings["params"])
    return {"/".join(k): tuple(v.spec) for k, v in flat.items()}, boxed


def _ref_path(pt, key, cfg):
    layer, path = pt.convert.tree_path(key, cfg.moe_experts > 0)
    return layer, ("layers/block/" if layer is not None else "") + "/".join(
        path)


def _spec_entry(entry):
    if entry is None:
        return None
    return entry if isinstance(entry, str) else list(entry)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("axes", [{"fsdp": 2, "model": 2},
                                  {"expert": 2, "data": 2},
                                  {"fsdp": 2, "expert": 2, "model": 2}],
                         ids=lambda a: "_".join(a))
def test_param_shardings_match_reference(axes, moe):
    pt = _port()
    kw = dict(moe_experts=4, moe_dispatch="ragged") if moe else {}
    want, _ = _ref_specs(ref_llama.tiny(**kw), axes)
    cfg = pt.llama.tiny(**kw)
    model = pt.llama.Llama(cfg, device="cpu")
    got = pt.sharding.param_shardings(model, axes)
    assert set(got) == set(dict(model.named_parameters()))
    for key, p in model.named_parameters():
        layer, path = _ref_path(pt, key, cfg)
        spec = list(want[path]) + [None] * (p.dim() + (layer is not None)
                                            - len(want[path]))
        if layer is not None:
            assert spec[0] is None  # the stacked layer dim: no pipeline
            spec = spec[1:]
        assert got[key].spec(p.dim()) == [_spec_entry(e) for e in spec], key
    # the same layout as placements, one per mesh dim
    from torch.distributed.tensor import Replicate, Shard

    wq = got["layers.0.attn.wq"]
    assert wq.placements == tuple(
        {"fsdp": Shard(0), "model": Shard(1)}.get(a, Replicate())
        for a in wq.axes)


def test_reshard_plan_matches_reference():
    pt = _port()
    cfg = ref_llama.tiny()
    src_mesh = ref_mesh.build_mesh({"fsdp": 2}, devices=jax.devices()[:2])
    dst_mesh = ref_mesh.build_mesh({"model": 2}, devices=jax.devices()[:2])
    model = ref_llama.Llama(cfg)
    boxed = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.ones((1, 8), np.int32)))
    params = nn.meta.unbox(boxed)["params"]
    want = {e["path"]: e for e in ref_shard.reshard_plan(
        params, ref_shard.param_shardings(boxed, src_mesh)["params"],
        ref_shard.param_shardings(boxed, dst_mesh)["params"])}

    pcfg = pt.llama.tiny()
    sd = pt.llama.Llama(pcfg, device="cpu").state_dict()
    src = pt.sharding.param_shardings(sd, {"fsdp": 2})
    dst = pt.sharding.param_shardings(sd, {"model": 2})
    got = pt.sharding.reshard_plan(sd, src, dst)
    assert [e["path"] for e in got] == list(sd)
    seen = set()
    for e in got:
        layer, path = _ref_path(pt, e["path"], pcfg)
        ref = want[path]
        seen.add(path)
        lead = 1 if layer is not None else 0
        assert e["shape"] == ref["shape"][lead:], path
        assert e["dtype"] == ref["dtype"], path
        assert e["src"] == ref["src"][lead:], path
        assert e["dst"] == ref["dst"][lead:], path
    assert seen == set(want)
    # 4 heads onto a model axis of 3: both refuse before moving anything
    bad_ref = ref_mesh.build_mesh({"model": 3}, devices=jax.devices()[:3])
    with pytest.raises(ValueError, match="does not divide"):
        ref_shard.reshard_plan(
            params, ref_shard.param_shardings(boxed, src_mesh)["params"],
            ref_shard.param_shardings(boxed, bad_ref)["params"])
    with pytest.raises(ValueError, match="does not divide"):
        pt.sharding.reshard_plan(
            sd, src, pt.sharding.param_shardings(sd, {"model": 3}))


@pytest.fixture
def one_rank_group():
    """A one-rank gloo process group in this process."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.utils.net import free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_mesh(axes):
    """Just the mesh queries ``shard_model`` makes: the axes' names and
    sizes, and, on the one-rank group, coordinate 0 and that group for
    every axis."""
    names = tuple(axes)

    def group(name):
        import torch.distributed as dist

        return dist.group.WORLD

    return types.SimpleNamespace(
        mesh_dim_names=names,
        mesh=types.SimpleNamespace(shape=tuple(axes.values())),
        size=lambda i: tuple(axes.values())[i],
        get_local_rank=lambda name: 0, get_group=group)


def test_unported_axes_and_features_raise_naming_items():
    pt = _port()
    # the seq and pipeline axes are laid out; what they cannot take raises
    dense = pt.llama.Llama(pt.llama.tiny(), device="cpu")
    with pytest.raises(ValueError, match="attention_impl='ring'"):
        pt.sharding.shard_model(dense, _fake_mesh({"seq": 2}))
    three = pt.llama.Llama(pt.llama.tiny(num_layers=3), device="cpu")
    with pytest.raises(ValueError, match="3 layers not divisible by 2"):
        pt.sharding.shard_model(three, _fake_mesh({"pipeline": 2}))
    # more devices than the job has (A13's MeshPlanError on a group)
    with pytest.raises(pt.mesh.MeshPlanError) as err:
        pt.mesh.plan_mesh({"fsdp": 2, "model": 2}, num_devices=2)
    with pytest.raises(ref_mesh.MeshPlanError) as want:
        ref_mesh.plan_mesh({"fsdp": 2, "model": 2}, num_devices=2)
    assert str(err.value) == str(want.value)


class _FsdpMesh:
    """A fake ``{"pipeline": 2, "fsdp": 2}`` mesh whose FSDP2 submesh is
    the real one-rank mesh."""

    def __init__(self, fake, real):
        self._fake, self._real = fake, real

    def __getattr__(self, name):
        return getattr(self._fake, name)

    def __getitem__(self, dims):
        return self._real


@pytest.mark.parametrize("case", ["lora", "int8", "capacity",
                                  "pipeline_fsdp"])
def test_former_refusals_lay_out(one_rank_group, case):
    """The layouts ``shard_model`` refused until ROADMAP A5c, A5d and A5g
    were ported now lay out: every key of an adapter or an int8 kernel is
    this rank's slice of what its logical axes split (``model``: heads,
    kv heads, mlp, vocab; ``lora`` and the in dims of a column-parallel
    kernel whole), the experts of the capacity dispatch split over
    ``expert``, and beside ``pipeline`` FSDP2 is one unit at the root."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import FSDPModule

    pt = _port()
    torch = pt.torch
    kw = {"lora": dict(lora_rank=2, lora_targets=("wq", "wv", "wo",
                                                  "w_down")),
          "int8": dict(quant_weights=True),
          "capacity": dict(moe_experts=4, moe_dispatch="dense"),
          "pipeline_fsdp": dict(num_layers=4)}[case]
    axes = {"lora": {"model": 2}, "int8": {"model": 2},
            "capacity": {"expert": 2},
            "pipeline_fsdp": {"pipeline": 2, "fsdp": 2}}[case]
    cfg = pt.llama.tiny(**kw)
    whole = pt.llama.Llama(cfg, device="cpu")
    full = {k: tuple(v.shape) for k, v in whole.state_dict().items()}
    mesh = _fake_mesh(axes)
    if case == "pipeline_fsdp":
        mesh = _FsdpMesh(mesh, DeviceMesh("cpu", torch.zeros(
            1, dtype=torch.int), mesh_dim_names=("fsdp",)))
    model = pt.llama.Llama(cfg, device="meta")
    layout = pt.sharding.shard_model(model, mesh)
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    if case == "pipeline_fsdp":
        assert layout.stage == [0, 1] and layout.gathers
        assert isinstance(model, FSDPModule)
        assert not any(isinstance(m, FSDPModule)
                       for m in model.modules() if m is not model)
        assert set(got) == {k for k in full if not k.startswith(
            ("layers.2.", "layers.3."))}
        return
    split = {"lora": ("heads", "kv_heads", "mlp", "vocab"),
             "int8": ("heads", "kv_heads", "mlp", "vocab"),
             "capacity": ("expert",)}[case]
    moe = cfg.moe_experts > 0
    assert set(got) == set(full)
    for key, shape in full.items():
        names = pt.sharding.param_axes(key, moe)
        want = tuple(n // 2 if a in split else n
                     for n, a in zip(shape, names))
        assert got[key] == want, key
    if case == "lora":
        # both kinds of product carry adapters: a whole factor each
        for key in ("layers.0.attn.wq_lora_a", "layers.0.attn.wo_lora_b"):
            assert got[key] == full[key], key
    if case == "int8":
        assert got["head.unembedding_scale"] == (cfg.vocab_size // 2,)


def test_one_rank_meshes(one_rank_group):
    import torch
    from torch.distributed.tensor import DTensor

    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    pt = _port()
    with pytest.raises(pt.mesh.MeshPlanError, match="ROADMAP A13"):
        pt.mesh.build_mesh({"fsdp": 2})
    mesh = pt.mesh.build_mesh({"fsdp": 1, "model": 1})
    assert mesh.mesh_dim_names == ("data",) and mesh.mesh.tolist() == [0]
    assert pt.mesh.batch_sharding(mesh) == (0, 1)

    cfg = TrainConfig(model=pt.llama.tiny(), global_batch=4, seq_len=16,
                      steps=3, warmup_steps=1, mu_dtype=None)
    with pytest.raises(pt.mesh.MeshPlanError, match="ROADMAP A13"):
        Trainer(TrainConfig(mesh_axes={"seq": 2}), device="cpu")
    plain = Trainer(cfg, device="cpu")
    assert plain.mesh is None
    sharded = Trainer(dataclasses.replace(cfg, mesh_axes={"fsdp": 1}),
                      device="cpu")
    assert sharded.mesh.mesh_dim_names == ("fsdp",)
    assert all(isinstance(p, DTensor) for p in sharded.model.parameters())
    plain.init_state(0)
    sharded.init_state(0)
    src = plain.data_source()
    for step in range(cfg.steps):
        tokens = src.local_batch(step)["tokens"]
        want, want_norm = plain.step(tokens)
        got, got_norm = sharded.step(tokens)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        np.testing.assert_allclose(float(got_norm), float(want_norm),
                                   rtol=1e-6)
    full = sharded.full_state_dict()
    for k, v in plain.model.state_dict().items():
        torch.testing.assert_close(full[k], v, rtol=1e-5, atol=1e-6)


def test_one_rank_fsdp_adafactor(one_rank_group):
    """Adafactor over FSDP2's one-rank shards (a width whose projections
    factor) takes the unwrapped model's steps."""
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    pt = _port()
    cfg = TrainConfig(model=pt.llama.tiny(hidden_size=128,
                                          intermediate_size=256,
                                          head_dim=32),
                      optimizer="adafactor", global_batch=4, seq_len=16,
                      steps=3, warmup_steps=1)
    plain = Trainer(cfg, device="cpu")
    sharded = Trainer(dataclasses.replace(cfg, mesh_axes={"fsdp": 1}),
                      device="cpu")
    plain.init_state(0)
    sharded.init_state(0)
    assert any(v is not None for v in sharded.opt.v_row)
    src = plain.data_source()
    for step in range(cfg.steps):
        tokens = src.local_batch(step)["tokens"]
        want, want_norm = plain.step(tokens)
        got, got_norm = sharded.step(tokens)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        np.testing.assert_allclose(float(got_norm), float(want_norm),
                                   rtol=1e-6)
    full = sharded.full_state_dict()
    for k, v in plain.model.state_dict().items():
        pt.torch.testing.assert_close(full[k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"moe_experts": 4, "moe_top_k": 2},
                                {"lora_rank": 2}, {"quant_weights": True},
                                {"tie_embeddings": True}],
                         ids=["dense", "moe", "lora", "int8", "tied"])
def test_streamed_init_equals_init_weights(kw):
    pt = _port()
    cfg = pt.llama.tiny(**kw)
    model = pt.llama.Llama(cfg, device="cpu")
    model.init_weights(3)
    want = model.state_dict()
    got: dict = {}
    pt.llama.Llama(cfg, device="meta").init_streamed(3, "cpu", got.update)
    assert set(got) == set(want)
    for k, v in want.items():
        assert pt.torch.equal(got[k], v), k
