"""Tensor parallelism of the UNet (``ldmseg_torch/parallel/tp.py``) against
the JAX package's ``parallel/tp.py`` on the conftest's virtual CPU devices:

  * ``tp_spec_for`` gives JAX's partition axis (after the layout
    transpose) for every UNet leaf, at toy width and at the SD-1.4 width
    (the JAX trees from ``jax.eval_shape``, no compute);
  * ``apply_tp``'s shards equal the ``addressable_shards`` of JAX's
    ``apply_tp`` on a ``(1, 2)`` mesh, GEGLU's ``proj`` with each rank's
    ``h`` and ``gate`` halves side by side;
  * on 2 gloo ranks, the TP UNet's forward, loss and every gradient
    against ``model.apply`` on JAX's TP params on a ``(1, 2)`` mesh, fp32,
    at JAX's own TP-vs-replicated bounds (``test_optim_parallel.py:157,
    189-194``): with 2 heads (local heads), 3 heads (the axis cuts a head:
    q, k, v gathered) and with gradient checkpointing;
  * the options the model axis does not take raise by name (those it
    takes since, with what their cut makes), and without a model axis
    nothing changes;
  * the shards of a UNet with ``use_packed_attention`` or
    ``use_absorbed_attention`` equal JAX's too.

The ranks run ``tests/torch_dp_workers.py`` (no JAX there), in a thread
while JAX compiles.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.parallel import apply_tp as japply_tp  # noqa: E402
from ldmseg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ldmseg_tpu.parallel.tp import tp_spec_for as jtp_spec_for  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa
from ldmseg_torch.parallel import tp  # noqa: E402
from ldmseg_torch.parallel.launch import run_ranks  # noqa: E402
from ldmseg_torch.parallel.mesh import Mesh  # noqa: E402
from ldmseg_torch.parallel.sp import model_axis  # noqa: E402

import torch_dp_workers as W  # noqa: E402
from test_torch_port_sampling import _random_params  # noqa: E402

FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
TOY = dict(in_channels=8, out_channels=4, block_out_channels=(16, 32),
           attn_down=(True, False), layers_per_block=1,
           attention_head_dim=2, norm_num_groups=4, use_fused_attention=True)
# 3 heads of 8 and 16: a model axis of 2 cuts the second head
SPLIT = dict(TOY, block_out_channels=(24, 48), attention_head_dim=3)
HW = (8, 12)


def _jax_unet(kw):
    import dataclasses
    fields = {f.name for f in dataclasses.fields(JUNetConfig)}
    return JUNet(JUNetConfig(use_cross_attention=False,
                             **{k: v for k, v in kw.items() if k in fields}))


def _jax_params(kw, seed=0):
    model = _jax_unet(kw)
    return model, _random_params(lambda: model.init(
        jax.random.key(0), jnp.zeros((1,) + HW + (kw["in_channels"],)),
        jnp.zeros((1,), jnp.int32)), seed)


def _torch_dim(spec, ndim):
    """The torch dim of a JAX PartitionSpec over ``model`` (None:
    replicated): conv ``[kh, kw, cin, cout]`` and dense ``[cin, cout]``
    transpose to ``[cout, cin, ...]``."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if "model" not in spec:
        return None
    i = spec.index("model")
    return {4: {3: 0, 2: 1}, 2: {1: 0, 0: 1}, 1: {0: 0}}[ndim][i]


def _path(path):
    return "/".join(str(getattr(k, "key", k)) for k in path[1:])


def _shapes(kw):
    model = _jax_unet(kw)
    return jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1,) + HW + (kw["in_channels"],)),
        jnp.zeros((1,), jnp.int32)))


def _jax_paths(kw):
    """Each port UNet parameter's JAX path, paired by
    ``convert.unet_state_dict_from_jax`` on a tree whose leaves hold their
    own index."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(_shapes(kw))
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32)
                  for i, (_, leaf) in enumerate(leaves)])
    out = {}
    for n, t in convert.unet_state_dict_from_jax(ids, UNetConfig(**kw)
                                                 ).items():
        i = torch.unique(t)
        assert i.numel() == 1, n
        out[n] = _path(leaves[int(i)][0])
    return out


@pytest.mark.parametrize("width", ["toy", "sd14"])
def test_tp_spec_for_gives_jax_axis(width):
    kw = TOY if width == "toy" else dict(in_channels=12)
    want = {_path(p): _torch_dim(jtp_spec_for(p, leaf, 2), len(leaf.shape))
            for p, leaf in jax.tree_util.tree_leaves_with_path(_shapes(kw))}
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(**kw))
    got = tp.tp_param_sharding(Mesh(model=2), unet)
    # the names paired at narrow widths of the same structure
    paths = _jax_paths(kw if width == "toy" else dict(
        kw, block_out_channels=(8, 16, 32, 32), norm_num_groups=4))
    assert sorted(paths.values()) == sorted(want), \
        set(paths.values()) ^ set(want)
    for n, d in got.items():
        assert d == want[paths[n]], (n, d, want[paths[n]])
    # something of each kind is sharded: column, row, a bias
    assert {0, 1} <= set(got.values())
    if width == "sd14":
        # norms, the time embedding: replicated; conv_out's 4 columns split
        assert got["conv_norm_out.weight"] is None
        assert got["time_embedding.linear_1.weight"] is None
        assert got["conv_out.weight"] == 0
        blk = "down_blocks.0.attentions.0.transformer_blocks.0"
        assert got[f"{blk}.attn1.to_out.0.weight"] == 1
        assert got[f"{blk}.attn1.to_out.0.bias"] is None
        assert got[f"{blk}.ff.net.2.weight"] == 1


# the UNet's attention flags whose cut JAX's apply_tp makes alike (the
# packed and absorbed attentions keep the same Dense kernels)
FLAGS = {"plain": {}, "packed": {"use_packed_attention": True},
         "absorbed": {"use_absorbed_attention": True}}


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("rank", [0, 1])
def test_shards_equal_jax_apply_tp(rank, flag):
    kw = dict(TOY, **FLAGS[flag])
    model, params = _jax_params(kw)
    mesh = jmake_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])
    placed = japply_tp(mesh, jax.tree_util.tree_map(jnp.asarray, params))
    device = mesh.devices[0, rank]
    sd = convert.unet_state_dict_from_jax(params, UNetConfig(**kw))
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(**kw))
    unet.to_empty(device="cpu")
    unet.load_state_dict(sd)
    tp.apply_tp(Mesh(model=2, model_rank=rank), unet)
    paths = _jax_paths(kw)
    leaves = {_path(p): leaf for p, leaf in
              jax.tree_util.tree_leaves_with_path(placed)}
    lay = tp.layout(unet)
    for n, p in unet.named_parameters():
        leaf = leaves[paths[n]]
        theirs = [np.asarray(s.data) for s in leaf.addressable_shards
                  if s.device == device][0]
        if theirs.ndim == 4:
            theirs = theirs.transpose(3, 2, 0, 1)
        elif theirs.ndim == 2:
            theirs = theirs.T
        ours = p.detach().numpy()
        if n.endswith("ff.net.0.proj.weight") or \
                n.endswith("ff.net.0.proj.bias"):
            # JAX: rank 0 holds h, rank 1 gate; each port rank its halves
            # of both, side by side
            assert lay[n] == (0, 2)
            full = sd[n].numpy()
            inner = full.shape[0] // 2
            assert np.array_equal(theirs, full[rank * inner:
                                               (rank + 1) * inner])
            half = inner // 2
            want = np.concatenate([full[rank * half:(rank + 1) * half],
                                   full[inner + rank * half:
                                        inner + (rank + 1) * half]])
            assert np.array_equal(ours, want), n
            continue
        assert np.array_equal(ours, theirs), n
        assert (n in lay) == (ours.shape != sd[n].shape), n
    share = (sum(p.numel() for p in unet.parameters())
             / sum(v.numel() for v in sd.values()))
    assert 0.5 < share < 0.55


def _jax_tp_step(kw, x, t, remat=False):
    """JAX's TP UNet on a ``(1, 2)`` mesh: out, loss and gradients of
    ``mean(out ** 2)``, the gradients in the port's names."""
    model, params = _jax_params(kw)
    mesh = jmake_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])
    tp_params = japply_tp(mesh, jax.tree_util.tree_map(jnp.asarray, params))
    xb = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    tj = jnp.asarray(t)

    def loss(p, xx):
        out = model.apply(p, xx, tj)
        return jnp.mean(out ** 2), out

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
        tp_params, xb).compile(compiler_options=FAST_XLA)
    (lv, out), g = fn(tp_params, xb)
    grads = convert.unet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, g), UNetConfig(**kw))
    return params, float(lv), np.asarray(out), grads


CASES = {"heads2": TOY, "heads3_split": SPLIT,
         "remat": dict(TOY, gradient_checkpointing=True)}


@pytest.fixture(scope="module")
def tp_runs():
    rng = np.random.RandomState(0)
    x = rng.randn(2, *HW, 8).astype(np.float32)
    t = np.array([3, 700], np.int32)
    refs = {}
    with ThreadPoolExecutor(1) as pool:
        # the weights come first (numpy draws), the ranks start while JAX
        # compiles its steps
        params = {c: _jax_params(CASES[c])[1] for c in ("heads2",
                                                         "heads3_split")}
        params["remat"] = params["heads2"]
        cases = [{"unet_kw": kw,
                  "sd": convert.unet_state_dict_from_jax(params[c],
                                                         UNetConfig(**kw)),
                  "x": x.transpose(0, 3, 1, 2).copy(),
                  "t": t.astype(np.int64)} for c, kw in CASES.items()]
        spawned = pool.submit(run_ranks, W.tp_unet, 2, args=(cases,),
                              device="cpu", timeout_s=240)
        for c in ("heads2", "heads3_split"):
            refs[c] = _jax_tp_step(CASES[c], x, t)
        refs["remat"] = refs["heads2"]
        ranks = spawned.result()
    return {c: (refs[c], [r[i] for r in ranks])
            for i, c in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_unet_matches_jax_tp(tp_runs, case):
    (_, jloss, jout, jgrads), ranks = tp_runs[case]
    for r in ranks:
        # the forward: JAX's TP bound (test_optim_parallel.py:157)
        np.testing.assert_allclose(r["out"].permute(0, 2, 3, 1).numpy(),
                                   jout, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-4)
    for rank, r in enumerate(ranks):
        ax = model_axis(Mesh(model=2, model_rank=rank))
        lay = r["layout"]
        assert lay and r["grads"].keys() == jgrads.keys()
        for n, g in r["grads"].items():
            want = jgrads[n]
            if n in lay:
                want = tp.local_tensor(want, lay[n][0], ax, lay[n][1])
            # test_optim_parallel.py:189-194
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=5e-3,
                                       atol=5e-4, err_msg=n)
    # every attention (down, mid, up) takes the model axis, a cut head too
    assert all(ranks[0]["attn_tp"]) and len(ranks[0]["attn_tp"]) == 4


def test_whole_tensor_inverts_local_tensor():
    x = torch.arange(48.0).reshape(8, 6)
    for dim, pairs in ((0, 1), (1, 1), (0, 2)):
        shards = [tp.local_tensor(x, dim, model_axis(Mesh(model=2,
                                                          model_rank=r)),
                                  pairs) for r in range(2)]
        assert torch.equal(tp.whole_tensor(shards, dim, pairs), x)


def _attn2_cut(unet):
    blk = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    return (isinstance(blk.attn2.to_k, tp.ColumnLinear)
            and not blk.attn2.to_k.gather
            and isinstance(blk.attn2.to_out[0], tp.RowLinear))


def _s8_convs_cut(unet):
    from ldmseg_torch.ops.quant import QuantConv2d
    lay = tp.layout(unet)
    convs = [(n, m) for n, m in unet.named_modules()
             if isinstance(m, QuantConv2d)]
    return convs and all(isinstance(m, tp.ColumnQuantConv2d)
                         and lay[f"{n}.weight"] == (0, 1)
                         and m.out_channels == m.weight.shape[0]
                         for n, m in convs)


def _packed_cut(unet):
    # K14 between to_q/k/v kept local and a row-parallel to_out, as K1
    blk = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    a = blk.attn1
    return (a.packed and isinstance(a.to_q, tp.ColumnLinear)
            and not a.to_q.gather and isinstance(a.to_out[0], tp.RowLinear)
            and not a.to_out[0].scatter)


def _absorbed_cut(unet):
    # K16 reads the weights itself: plain Linear layers holding a rank's
    # heads, the model group as tp_group
    blk = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    a, lay = blk.attn1, tp.layout(unet)
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    return (a.absorbed and type(a.to_q) is torch.nn.Linear
            and type(a.to_out[0]) is torch.nn.Linear
            and isinstance(a.tp_group, tp.ModelGroup)
            and lay[f"{name}.to_q.weight"] == (0, 1)
            and lay[f"{name}.to_out.0.weight"] == (1, 1)
            and f"{name}.to_out.0.bias" not in lay
            and tuple(a.to_q.weight.shape) == (8, 16)
            and tuple(a.to_out[0].weight.shape) == (16, 8))


# the options apply_tp takes since serving came to the model axis, each
# with what its cut makes (held against JAX in
# test_torch_port_model_axis_serving, test_torch_port_model_axis_context
# and test_torch_port_model_axis_attention*)
NOW_TAKEN = {"use_cross_attention": _attn2_cut,
             "use_int8_conv": _s8_convs_cut,
             "use_packed_attention": _packed_cut,
             "use_absorbed_attention": _absorbed_cut}


@pytest.mark.parametrize("key", [
    "use_cross_attention", "separate_conv", "use_packed_attention",
    "use_absorbed_attention", "use_int8_conv", "upscaler_classes"])
def test_apply_tp_refuses_what_it_does_not_take(key):
    import dataclasses
    cfg = dataclasses.replace(UNetConfig(**TOY), **{
        key: 5 if key == "upscaler_classes" else True})
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    if key in NOW_TAKEN:
        tp.apply_tp(Mesh(model=2), unet)
        assert NOW_TAKEN[key](unet)
        return
    with pytest.raises(NotImplementedError, match=key):
        tp.apply_tp(Mesh(model=2), unet)


def _padded_cut(unet):
    # K11 reads its four weights itself: plain Linear layers holding a
    # rank's heads, the model group as tp_group
    from ldmseg_torch.models.unet import PaddedAttentionS8
    blk = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    a, lay = blk.attn1, tp.layout(unet)
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    return (type(a) is PaddedAttentionS8
            and type(a.to_q) is torch.nn.Linear
            and type(a.to_out[0]) is torch.nn.Linear
            and isinstance(a.tp_group, tp.ModelGroup)
            and lay[f"{name}.to_q.weight"] == (0, 1)
            and lay[f"{name}.to_out.0.weight"] == (1, 1)
            and tuple(a.to_q.weight.shape) == (8, 16)
            and tuple(a.to_out[0].weight.shape) == (16, 8))


def _fuse_gn_cut(unet):
    # K6 whole on the replicated activation (its norms replicated), into
    # the column-parallel s8 convs
    from ldmseg_torch.models.layers import ResnetBlock
    res = [m for m in unet.modules() if isinstance(m, ResnetBlock)]
    return (_s8_convs_cut(unet) and res
            and all(m.norm1.quantize and m.norm2.quantize for m in res)
            and not any(".norm" in n for n in tp.layout(unet)))


def _undivided_k3(unet):
    # 3 heads over 2 ranks: K3 takes no group (the one-rank kernel on a
    # whole pack on every rank), K4 a rank's 4C columns
    from ldmseg_torch.models.unet import LNAttentionS8
    blk = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    return (type(blk.attn1) is LNAttentionS8 and blk.attn1.tp_group is None
            and isinstance(blk.ff.tp_group, tp.ModelGroup))


# the int8 options apply_tp takes since, with what their cut
# makes (held against one rank and JAX in
# test_torch_port_model_axis_int8_options*)
INT8_NOW_TAKEN = {"use_padded_attention": _padded_cut,
                  "int8_fuse_gn": _fuse_gn_cut,
                  "use_fused_norms": _undivided_k3}


@pytest.mark.parametrize("key", ["use_padded_attention", "int8_fuse_gn",
                                 "use_fused_norms"])
def test_apply_tp_refuses_the_int8_options_it_does_not_take(key):
    # K11 (padded attention without fused norms), K6, and K3 where the
    # axis does not divide the heads: all taken now
    kw = dict(TOY, use_int8_conv=True, **{key: True})
    if key == "use_fused_norms":
        kw.update(SPLIT, use_padded_attention=True, use_int8_conv=True,
                  use_fused_norms=True, use_int8_ff=True, use_fused_ff=True)
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(**kw))
    if key in INT8_NOW_TAKEN:
        tp.apply_tp(Mesh(model=2), unet)
        assert INT8_NOW_TAKEN[key](unet)
        return
    with pytest.raises(NotImplementedError, match=key):
        tp.apply_tp(Mesh(model=2), unet)


def test_without_a_model_axis_nothing_changes():
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(**TOY))
    before = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    assert tp.apply_tp(Mesh(), unet) is unet and not tp.layout(unet)
    assert {n: tuple(p.shape) for n, p in unet.named_parameters()} == before
    assert set(tp.tp_param_sharding(Mesh(), unet).values()) == {None}
