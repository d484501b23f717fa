"""The port's table-driven DDIM sampler against the JAX package's
``ddim_sample`` (one ``lax.scan``) on the CPU, and its counter replay.

- ``ddim_sample`` (the eager loop, which the CPU runs) against JAX's on the
  same numpy noise, with a seeded linear ``model_fn`` for each prediction
  type, with and without self-conditioning, ``tmin`` and ``return_all``, and
  with a tiny UNet on the same weights; fp32 within 1e-5 of max|ref| (the
  step's coefficients are rounded once from float64 here and computed in
  fp32 there: an ulp apart).
- The loop against the previous eager arithmetic (``ddim_step`` at each
  Python timestep) within the same bound, and the table against float64.
- ``CountReplay`` on stub wrappers: a capture's counts come off, each
  replay adds them back.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.diffusion import ddim  # noqa: E402
from ldmseg_torch.diffusion.sampler import ddim_sample  # noqa: E402
from ldmseg_torch.models.convert import unet_state_dict_from_jax  # noqa
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa
from ldmseg_torch.ops.counters import CountReplay, counted_wrappers  # noqa
from ldmseg_torch.utils.config import DEFAULT_CONFIG  # noqa: E402

CPU = torch.device("cpu")
NOISE_KW = DEFAULT_CONFIG["noise_scheduler_kwargs"]


def _models(seed):
    a = np.random.RandomState(seed).randn(4, 4).astype(np.float32) * 0.3

    def jmodel(latents, condition, t):
        base = latents @ jnp.asarray(a) * (t / 1000.0)
        return base if condition is None else base + 0.1 * condition

    def tmodel(latents, condition, t):
        x = latents.permute(0, 2, 3, 1)
        base = x @ torch.from_numpy(a) * (t / 1000.0)
        if condition is not None:
            base = base + 0.1 * condition.permute(0, 2, 3, 1)
        return base.permute(0, 3, 1, 2)
    return jmodel, tmodel


def _close(ours, ref, scale):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("self_condition,tmin,return_all", [
    (False, 0, True), (True, 0, False), (True, 450, True)])
def test_table_sampler_matches_jax(prediction_type, self_condition, tmin,
                                   return_all):
    kw = dict(NOISE_KW, prediction_type=prediction_type)
    init = np.random.RandomState(tmin + 7).randn(2, 4, 6, 4).astype(
        np.float32)
    jmodel, tmodel = _models(3)
    ref = jddim_sample(jddim.make_ddim_schedule(**kw), jmodel,
                       jnp.asarray(init), num_inference_steps=10,
                       self_condition=self_condition, tmin=tmin,
                       return_all=return_all)
    out = ddim_sample(ddim.make_ddim_schedule(**kw, device=CPU), tmodel,
                      torch.from_numpy(init).permute(0, 3, 1, 2),
                      num_inference_steps=10, self_condition=self_condition,
                      tmin=tmin, return_all=return_all)
    if return_all:
        (ref_x0, ref_traj), (x0, traj) = ref, out
        ref_traj = np.asarray(ref_traj)
        scale = max(1.0, float(np.abs(ref_traj).max()))
        assert traj.shape[0] == ref_traj.shape[0] > 0
        _close(traj.permute(0, 1, 3, 4, 2).numpy(), ref_traj, scale)
    else:
        ref_x0, x0 = ref, out
        scale = max(1.0, float(np.abs(np.asarray(ref_x0)).max()))
    _close(x0.permute(0, 2, 3, 1).numpy(), np.asarray(ref_x0), scale)


UNET_KW = dict(out_channels=4, block_out_channels=(8, 16),
               attn_down=(True, False), layers_per_block=1,
               attention_head_dim=2, norm_num_groups=4)


def _unet_params(unet, seed, in_channels):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 4, 8, in_channels)),
        jnp.zeros((1,), jnp.int32)))

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.randn(*leaf.shape).astype(np.float32) / fan_in**0.5
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("self_condition", [False, True])
def test_table_sampler_on_a_tiny_unet_matches_jax(self_condition):
    """The UNet predicts from [latents, rgb(, condition)] as the trainer's
    model_fn does; 4 steps."""
    cond = 4 if self_condition else 0
    jcfg = JUNetConfig(in_channels=8 + cond, cond_channels=cond,
                       use_cross_attention=False, **UNET_KW)
    junet = JUNet(jcfg)
    params = _unet_params(junet, 1, 8 + cond)
    unet = UNet2DCondition(UNetConfig(in_channels=8 + cond, **UNET_KW))
    unet.load_state_dict(unet_state_dict_from_jax(params, unet.config))
    rng = np.random.RandomState(2)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    rgb = rng.randn(2, 4, 8, 4).astype(np.float32)
    sched = jddim.make_ddim_schedule(**NOISE_KW)

    def jmodel(latents, condition, t):
        parts = [latents, jnp.asarray(rgb)] + (
            [condition] if condition is not None else [])
        return junet.apply(params, jnp.concatenate(parts, -1),
                           jnp.broadcast_to(t, (2,)))
    ref = np.asarray(jax.jit(lambda z: jddim_sample(
        sched, jmodel, z, num_inference_steps=4,
        self_condition=self_condition))(jnp.asarray(init)))
    trgb = torch.from_numpy(rgb).permute(0, 3, 1, 2)

    def tmodel(latents, condition, t):
        assert t.dim() == 0 and t.dtype == torch.long
        parts = [latents, trgb] + ([condition] if condition is not None
                                   else [])
        return unet(torch.cat(parts, 1), t)
    with torch.inference_mode():
        x0 = ddim_sample(ddim.make_ddim_schedule(**NOISE_KW, device=CPU),
                         tmodel, torch.from_numpy(init).permute(0, 3, 1, 2),
                         num_inference_steps=4,
                         self_condition=self_condition)
    _close(x0.permute(0, 2, 3, 1).numpy(), ref,
           max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "sample", "v_prediction"])
def test_eager_loop_matches_the_previous_arithmetic(prediction_type):
    """``ddim_step`` at each Python timestep, the loop before the table."""
    kw = dict(NOISE_KW, prediction_type=prediction_type)
    sched = ddim.make_ddim_schedule(**kw, device=CPU)
    init = torch.from_numpy(np.random.RandomState(5).randn(
        2, 4, 6, 4).astype(np.float32))
    _, tmodel = _models(4)
    latents, cond, prev_x0 = init.clone(), torch.zeros_like(init), None
    for t in ddim.inference_timesteps(1000, 20):
        pred = tmodel(latents, cond, int(t))
        latents, prev_x0 = ddim.ddim_step(sched, pred, int(t), latents, 20)
        cond = prev_x0
    x0 = ddim_sample(sched, tmodel, init, num_inference_steps=20,
                     self_condition=True, graph=False)
    _close(x0.numpy(), prev_x0.numpy(),
           max(1.0, float(prev_x0.abs().max())))


def test_step_table_is_the_float64_schedule_rounded_once():
    sched = ddim.make_ddim_schedule(**NOISE_KW, device=CPU)
    table = ddim.step_table(sched, 50, tmin=100)
    assert ddim.step_table(sched, 50, tmin=100) is table
    ts = ddim.inference_timesteps(1000, 50, tmin=100)
    np.testing.assert_array_equal(table.timesteps.numpy(), ts)
    ac = sched.alphas_cumprod.numpy().astype(np.float64)
    prev = ts - 20
    ap = np.where(prev >= 0, ac[np.clip(prev, 0, None)],
                  float(sched.final_alpha_cumprod))
    want = np.stack([np.sqrt(ac[ts]), np.sqrt(1 - ac[ts]),
                     1 / np.sqrt(ac[ts]), 1 / np.sqrt(1 - ac[ts]),
                     np.sqrt(ap), np.sqrt(1 - ap)], 1).astype(np.float32)
    np.testing.assert_array_equal(table.coef.numpy(), want)
    assert table.coef.dtype == torch.float32 and len(table) == len(ts)


def test_graph_needs_cuda_latents():
    sched = ddim.make_ddim_schedule(**NOISE_KW, device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        ddim_sample(sched, lambda x, c, t: x, torch.zeros(1, 4, 2, 2),
                    num_inference_steps=2, graph=True)


def test_unet_takes_a_device_timestep_tensor():
    torch.manual_seed(0)
    unet = UNet2DCondition(UNetConfig(in_channels=8, **UNET_KW)).eval()
    x = torch.randn(2, 8, 8, 8)
    with torch.inference_mode():
        ref = unet(x, 999)
        assert torch.equal(unet(x, torch.tensor(999)), ref)
        assert torch.equal(unet(x, torch.tensor([999, 999])), ref)


@pytest.mark.parametrize("timesteps", [[999, 19], np.array([999, 19])],
                         ids=["list", "numpy"])
def test_unet_takes_a_batch_of_host_timesteps(timesteps):
    torch.manual_seed(0)
    unet = UNet2DCondition(UNetConfig(in_channels=8, **UNET_KW)).eval()
    x = torch.randn(2, 8, 8, 8)
    with torch.inference_mode():
        assert torch.equal(unet(x, timesteps),
                           unet(x, torch.tensor([999, 19])))


def _stub(fallbacks=True):
    def fn():
        fn.launches += 1
    fn.launches = 0
    if fallbacks:
        fn.fallbacks = 0
    return fn


def test_count_replay_on_stubs():
    a, b, c = _stub(), _stub(False), _stub()
    a.launches, b.launches, c.fallbacks = 5, 2, 1
    rec = CountReplay([a, b, c])
    rec.start()
    for _ in range(3):      # what one captured step counts
        a()
    b()
    c.fallbacks += 2
    rec.stop()
    assert (a.launches, b.launches, c.launches, c.fallbacks) == (5, 2, 0, 1)
    rec.replay()
    rec.replay(4)
    assert (a.launches, b.launches, c.launches, c.fallbacks) == (
        5 + 15, 2 + 5, 0, 1 + 10)
    assert a.fallbacks == 0
    with pytest.raises(RuntimeError):
        CountReplay([a]).stop()


def test_counted_wrappers_are_every_kernel_wrapper():
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.ops import gn_silu_conv as GC
    from ldmseg_torch.ops import groupnorm_silu as GN
    fns = counted_wrappers()
    for fn in (A.fused_self_attention, A.fused_self_attention_backward,
               A.fused_self_attention_packed, A.absorbed_self_attention,
               S8.ln_attention_s8, S8.ln_attention_s8_pin,
               S8.padded_attention_s8, S8.fused_self_attention_s8,
               S8.fused_self_attention_packed_s8,
               S8.ln_attention_s8_rowmajor, S8.absorbed_self_attention_s8,
               S8.absorbed_fullc_self_attention_s8, S8.ln_quant_s8,
               G.geglu_ln_s8, G.geglu_ln_s8_pout, G.fused_geglu_s8,
               GN.group_norm_silu, GN.group_norm_silu_quant,
               GC.gn_silu_conv):
        assert any(f is fn for f in fns), fn.__name__
    assert len({id(f) for f in fns}) == len(fns)
