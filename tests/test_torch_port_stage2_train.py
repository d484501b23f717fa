"""The rest of stage-2 training in the port against the JAX package on the
CPU: Adafactor against optax over 3 steps (1e-6 relative), the UNet's
input dropout in both modes with the mask or noise JAX drew (1e-5 of
max|ref|), gradient checkpointing (the same gradients as without it, for
every ``remat_policy`` the port maps; nothing random inside a remat
block), the int8 straight-through gradients against JAX's ``custom_vjp``
(1e-5 of max|ref|), the RGB posterior sample, and the trainer's image
logging.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
flax = pytest.importorskip("flax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as jnn  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_tpu.train import optim as joptim  # noqa: E402
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import (REMAT_POLICIES,  # noqa: E402
                                      UNet2DCondition, UNetConfig)
from ldmseg_torch.ops.quant import Int8ConvSTE, Int8LinearSTE  # noqa
from ldmseg_torch.train import optim  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_sampling import CFG, UNET_KW, _random_params  # noqa

CPU = torch.device("cpu")
# XLA's CPU backend at its lowest optimisation level: a fraction of the
# compile time
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    several workers at once, and torch's default pool of every core in
    each of them costs more than it gains here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    # always a copy: a tensor that shares a numpy array with the JAX side
    # would let an in-place update reach JAX's pending work (on the CPU, JAX
    # reads an aligned numpy operand in place and asynchronously)
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _nchw(x):
    return _t(np.asarray(x, np.float32).transpose(0, 3, 1, 2))


def _close(out, ref, tol):
    """max |out - ref| <= tol * max(1, max|ref|)."""
    ref = np.asarray(ref, np.float32)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


# ---------------------------------------------------------------------------
# Adafactor against optax (1e-6 relative)
# ---------------------------------------------------------------------------
def test_adafactor_matches_optax_over_three_steps():
    rng = np.random.RandomState(0)
    # one factored leaf (160 x 130), and three unfactored ones (a conv with
    # 8 inputs, a bias, a norm scale)
    tree = {"dense": {"kernel": rng.randn(160, 130), "bias": rng.randn(130)},
            "norm": {"scale": rng.randn(7)},
            "conv": {"kernel": rng.randn(3, 3, 8, 140)}}
    tree = jax.tree_util.tree_map(lambda x: x.astype(np.float32), tree)
    to_port = {"dense.weight": lambda t: t["dense"]["kernel"].T,
               "dense.bias": lambda t: t["dense"]["bias"],
               "norm.weight": lambda t: t["norm"]["scale"],
               "conv.weight": lambda t: t["conv"]["kernel"].transpose(
                   3, 2, 0, 1)}
    kw = dict(learning_rate=1e-2, weight_decay=0.1, weight_decay_norm=0.0,
              clip_grad=1.0)
    tx = joptim.make_optimizer("adafactor", **kw)
    opt_state, params = tx.init(tree), tree
    named = [(k, torch.nn.Parameter(_t(f(tree)))) for k, f in
             to_port.items()]
    opt = optim.Optimizer(named, "adafactor", **kw)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*x.shape).astype(np.float32), tree)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in named:
            p.grad = _t(to_port[k](grads))
        opt.step()
    for k, p in named:
        ref = np.asarray(to_port[k](params))
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)
    assert optim.factored_dims((130, 160)) == (0, 1)
    assert optim.factored_dims((140, 130, 3, 3)) == (1, 0)
    assert optim.factored_dims((140, 8, 3, 3)) is None
    assert optim.factored_dims((127, 4000)) is None
    # its moments survive state_dict / load_state_dict_
    back = optim.Optimizer([(k, torch.nn.Parameter(p.detach().clone()))
                            for k, p in named], "adafactor", **kw)
    back.load_state_dict_(opt.state_dict())
    assert back.count == 3
    for i, st in opt.factored.state.items():
        for key, v in st.items():
            assert torch.equal(back.factored.state[i][key], v)


# ---------------------------------------------------------------------------
# the UNet's input dropout against JAX (1e-5 of max|ref|)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_unet():
    jcfg = JUNetConfig(use_cross_attention=False, cond_channels=4,
                       **UNET_KW)
    params = _random_params(lambda: JUNet(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 12)),
        jnp.zeros((1,), jnp.int32)), 0)
    return jcfg, params, convert.unet_state_dict_from_jax(
        params, UNetConfig(**UNET_KW))


def _port_unet(sd, **kw):
    unet = UNet2DCondition(UNetConfig(**UNET_KW, **kw))
    unet.load_state_dict(sd, strict=True)
    return unet


@pytest.mark.parametrize("mode", ["standard", "gaussian"])
def test_input_dropout_matches_jax(tiny_unet, mode):
    jcfg, params, sd = tiny_unet
    import dataclasses
    junet = JUNet(dataclasses.replace(jcfg, dropout=0.3, dropout_mode=mode))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 12).astype(np.float32)
    t = np.array([10, 700])
    def run(params, x, t):
        seen = {}

        def grab(next_fun, args, kwargs, context):
            if context.module.name == "conv_in":
                seen["x"] = args[0]   # conv_in's input: the dropped sample
            return next_fun(*args, **kwargs)

        with jnn.intercept_methods(grab):
            y = junet.apply(params, x, t, deterministic=False,
                            rngs={"dropout": jax.random.key(2)})
        return y, seen["x"]

    args = (params, jnp.asarray(x), jnp.asarray(t))
    ref, dropped = jax.jit(run).lower(*args).compile(
        compiler_options=FAST_XLA)(*args)
    dropped = np.asarray(dropped)
    if mode == "standard":
        draw = _nchw(dropped != 0)
        _close(dropped[dropped != 0], x[dropped != 0] / 0.7, 1e-6)
    else:
        p = 0.3 / 0.7
        draw = _nchw((dropped / x - 1.0) / (p / (1 - p)) ** 0.5)
    unet = _port_unet(sd, dropout=0.3, dropout_mode=mode)
    with torch.no_grad():
        ours = unet(_nchw(x), torch.from_numpy(t), dropout=draw)
        plain = unet(_nchw(x), torch.from_numpy(t))
    _close(ours.permute(0, 2, 3, 1).numpy(), ref, 1e-5)
    assert not torch.allclose(ours, plain)


# ---------------------------------------------------------------------------
# gradient checkpointing: the same gradients; nothing random inside
# ---------------------------------------------------------------------------
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _grads(unet, x, t, draw):
    unet.zero_grad(set_to_none=True)
    out = unet(x, t, dropout=draw)
    (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum() \
        .backward()
    return {n: p.grad.clone() for n, p in unet.named_parameters()}


def test_gradient_checkpointing_keeps_the_gradients(tiny_unet):
    _, _, sd = tiny_unet
    rng = np.random.RandomState(3)
    x, t = _t(rng.randn(2, 12, 8, 8)), torch.tensor([5, 900])
    draw = torch.from_numpy(rng.rand(2, 12, 8, 8) < 0.8)
    ref = _grads(_port_unet(sd, dropout=0.2), x, t, draw)
    for policy in sorted(REMAT_POLICIES, key=str):
        unet = _port_unet(sd, dropout=0.2, gradient_checkpointing=True,
                          remat_policy=policy)
        with _Ops() as ops:
            got = _grads(unet, x, t, draw)
        for n, g in ref.items():
            torch.testing.assert_close(got[n], g, rtol=0, atol=0, msg=n)
        # the draws come from outside: no random op ran, in the forward or
        # in the recompute
        assert not [n for n in ops.names if any(
            r in n for r in ("rand", "bernoulli", "normal", "uniform",
                             "exponential", "dropout"))]
    with pytest.raises(ValueError, match="remat_policy"):
        UNet2DCondition(UNetConfig(**UNET_KW, gradient_checkpointing=True,
                                   remat_policy="save_only_these_names"))


def test_remat_recomputes_the_attention_in_the_backward(tiny_unet):
    """K1's autograd.Function runs again in the recompute: its forward
    twice for each site of a remat block (the mid block is not one)."""
    from ldmseg_torch.ops import attention
    _, _, sd = tiny_unet
    calls = []
    orig = attention._FusedSelfAttention.forward

    def counted(ctx, *args):
        calls.append(1)
        return orig(ctx, *args)
    x, t = _t(np.random.RandomState(4).randn(2, 12, 8, 8)), torch.tensor(
        [1, 2])
    counts = []
    for remat in (False, True):
        unet = _port_unet(sd, gradient_checkpointing=remat)
        calls.clear()
        attention._FusedSelfAttention.forward = staticmethod(counted)
        try:
            unet(x, t).sum().backward()
        finally:
            attention._FusedSelfAttention.forward = orig
        counts.append(len(calls))
    # sites: down block 0 (1), the mid block (1), up block 1 (2); remat
    # repeats the down and up blocks' three
    assert counts == [4, 7]


# ---------------------------------------------------------------------------
# training through int8 (the straight-through backward, 1e-5)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_straight_through_matches_jax(stride):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 9, 6).astype(np.float32)
    w = (rng.randn(3, 3, 6, 5) / 7).astype(np.float32)
    pad = [(1, 1), (1, 1)]

    def f(x, w):
        y = jquant.int8_conv(x, w, (stride, stride), pad, None)
        return jnp.sum(y * jnp.cos(jnp.arange(y.size).reshape(y.shape)))
    (gx, gw), y = jax.grad(f, argnums=(0, 1))(x, w), jquant.int8_conv(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), pad, None)
    tx = _nchw(x).requires_grad_(True)
    tw = _t(w.transpose(3, 2, 0, 1)).requires_grad_(True)
    out = Int8ConvSTE.apply(tx, tw, stride, None)
    _close(out.detach().permute(0, 2, 3, 1).numpy(), y, 1e-5)
    cos = torch.cos(torch.arange(out.numel(), dtype=torch.float32)).reshape(
        out.permute(0, 2, 3, 1).shape)
    (out.permute(0, 2, 3, 1) * cos).sum().backward()
    _close(tx.grad.permute(0, 2, 3, 1).numpy(), gx, 1e-5)
    _close(tw.grad.permute(2, 3, 1, 0).numpy(), gw, 1e-5)


def test_int8_dot_straight_through_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 4, 10).astype(np.float32)
    k = (rng.randn(10, 7) / 3).astype(np.float32)

    def f(x, k):
        return jnp.sum(jquant.int8_dot(x, k, 0.05) ** 2)
    gx, gk = jax.grad(f, argnums=(0, 1))(x, k)
    tx, tk = _t(x).requires_grad_(True), _t(k.T).requires_grad_(True)
    y = Int8LinearSTE.apply(tx, tk, 0.05)
    _close(y.detach().numpy(), jquant.int8_dot(jnp.asarray(x),
                                               jnp.asarray(k), 0.05), 1e-5)
    (y ** 2).sum().backward()
    _close(tx.grad.numpy(), gx, 1e-5)
    _close(tk.grad.numpy().T, gk, 1e-5)


def test_int8_unet_trains_through_the_straight_through_path(tiny_unet):
    _, _, sd = tiny_unet
    unet = _port_unet(sd, use_int8_conv=True, use_int8_ff=True,
                      int8_act_scale=0.05)
    x, t = _t(np.random.RandomState(7).randn(2, 12, 8, 8)), torch.tensor(
        [3, 4])
    unet(x, t).square().mean().backward()
    conv = unet.down_blocks[0].resnets[0].conv1
    ff = unet.down_blocks[0].attentions[0].transformer_blocks[0].ff.net[2]
    assert conv.w_q is None and ff.w_q is None
    assert conv.weight.grad.abs().sum() > 0 and ff.weight.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the RGB posterior sample and image logging in the trainer
# ---------------------------------------------------------------------------
def test_rgb_posterior_sample_and_image_logging(tmp_path):
    cfg = merge_dicts(CFG, {"train_kwargs": {
        "sample_posterior_rgb": True, "batch_size": 2, "dropout": 0.1,
        "gradient_checkpointing": True}, "optimizer_name": "adafactor"})
    ds = SyntheticDVPS(length=4, size=(32, 64), num_bits=5)
    tr = TrainerDiffusion(cfg, unet_config=UNetConfig(
        **UNET_KW, dropout=0.1, gradient_checkpointing=True), device=CPU,
        dataset=ds, val_dataset=ds, results_folder=str(tmp_path))
    tr.init_params(seed=2)
    image = np.random.RandomState(8).randn(2, 32, 64, 3).astype(np.float32)
    jvae = JImageVAE(block_out_channels=(8, 8, 16, 16), groups=8,
                     decoder_enabled=False)
    jparams = _random_params(lambda: jvae.init(
        jax.random.key(0), jnp.zeros((1, 32, 64, 3)),
        method=JImageVAE.encode), 9)
    tr.load_state_dicts(vae_img=convert.image_vae_state_dict_from_jax(
        jparams))
    post = jvae.apply(jparams, 2.0 * np.clip(
        image * np.array([0.229, 0.224, 0.225], np.float32)
        + np.array([0.485, 0.456, 0.406], np.float32), 0, 1) - 1.0,
        method=JImageVAE.encode)
    noise = np.random.RandomState(10).randn(*post.mean.shape).astype(
        np.float32)
    want = (post.mean + jnp.exp(0.5 * post.logvar) * noise) * 0.18215
    with torch.no_grad():
        got = tr._encode_rgb(image, noise=_nchw(noise))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)
    losses = tr.train_loop(max_steps=2, log_every=1, vis_every=1)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tr.state.optimizer.factored is not None
    logits, _ = tr.sample_panoptic(_collate(ds), num_inference_steps=1)
    path = tr.log_images_val(_collate(ds), logits, identifier="_x")
    names = sorted(os.listdir(tmp_path))
    assert {"rgb_gt_pred_1.jpg", "rgb_gt_pred_2.jpg",
            "overview_x.png"} <= set(names)
    from PIL import Image
    # rows: RGB, ground truth, prediction, inpainting mask
    assert Image.open(path).size[1] == 4 * 32
    assert Image.open(tr.visualize_noise_schedule()).size == (64, 6 * 32)


def _collate(ds):
    from ldmseg_torch.data.collate import collate
    return collate([ds[0], ds[1]])


def test_remat_under_the_trainers_cast_keeps_the_gradients():
    """The trainer runs the UNet on a bf16 cast of its masters through
    ``functional_call``; the recompute in the backward must read that cast,
    not the fp32 masters."""
    import dataclasses
    cfg = merge_dicts(CFG, {"train_kwargs": {
        "weight_dtype": "bfloat16", "batch_size": 2,
        "gradient_checkpointing": True}})
    ds = SyntheticDVPS(length=2, size=(32, 64), num_bits=5)
    tr = TrainerDiffusion(cfg, unet_config=UNetConfig(
        **UNET_KW, gradient_checkpointing=True), device=CPU)
    tr.init_params(seed=3)
    batch = _collate(ds)
    rng = np.random.RandomState(11)
    noise, steps = rng.randn(2, 4, 8, 4).astype(np.float32), [7, 640]
    grads = {}
    for remat in (True, False):
        tr.unet.config = dataclasses.replace(tr.unet.config,
                                             gradient_checkpointing=remat)
        tr.state.zero_grad()
        tr.forward_backward(batch, noise=noise, timesteps=steps)
        grads[remat] = {n: p.grad.clone()
                        for n, p in tr.unet.named_parameters()}
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=0, atol=0,
                                   msg=n)
