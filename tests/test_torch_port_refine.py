"""The port's ``ddim_refine`` against the JAX package's on the CPU.

The DDIM tail of k = max(1, min(S, round(strength * S))) steps (Python's
rounding, half to even) after re-noising an x0 estimate, on a tiny model
function and on the tiny UNet of ``test_torch_port_sampling``, for
strengths 0.3 and 0.5 (and two that round to 0 and to a half) and S = 4, 7
and 50, with and without self-conditioning: within 1e-5 * max(1, |ref|).
The tail replays the rows of the S-step table that ``ddim_sample`` runs.
``graph=True`` on a CPU tensor raises.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_refine as jrefine  # noqa
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.diffusion import ddim  # noqa: E402
from ldmseg_torch.diffusion.sampler import ddim_refine, ddim_sample  # noqa
from ldmseg_torch.models.convert import unet_state_dict_from_jax  # noqa
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa

from test_torch_port_sampling import UNET_KW, _random_params  # noqa: E402

CPU = torch.device("cpu")
NOISE_KW = {"beta_schedule": "scaled_linear", "beta_start": 0.00085,
            "beta_end": 0.012, "num_train_timesteps": 1000,
            "prediction_type": "epsilon", "clip_sample": False}
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
CASES = [(s, st) for s in (4, 7, 50) for st in (0.3, 0.5)] + [
    (4, 0.125), (4, 0.625)]  # round(0.5) = 0 -> k = 1; round(2.5) = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2).contiguous()


def _close(ours, ref):
    ref = np.asarray(ref)
    bound = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=bound)


def _inputs(seed, shape=(2, 4, 8, 4)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _k(steps, strength):
    return max(1, min(steps, int(round(strength * steps))))


@pytest.mark.parametrize("self_condition", [False, True])
@pytest.mark.parametrize("steps,strength", CASES)
def test_refine_matches_jax_on_a_model_function(steps, strength,
                                                self_condition):
    x0, noise = _inputs(steps)
    seen = []

    def jfn(lat, cond, t):
        c = 0.0 if cond is None else 0.2 * cond
        return 0.3 * lat + c + 1e-3 * t

    def tfn(lat, cond, t):
        seen.append(int(t))
        c = 0.0 if cond is None else 0.2 * cond
        return 0.3 * lat + c + 1e-3 * t

    jsched = jddim.make_ddim_schedule(**NOISE_KW)
    ref = jax.jit(lambda a, b: jrefine(
        jsched, jfn, a, b, num_inference_steps=steps, strength=strength,
        self_condition=self_condition))(jnp.asarray(x0), jnp.asarray(noise))
    sched = ddim.make_ddim_schedule(**NOISE_KW, device=CPU)
    x0_t = _nchw(x0)
    out = ddim_refine(sched, tfn, x0_t, _nchw(noise),
                      num_inference_steps=steps, strength=strength,
                      self_condition=self_condition)
    _close(out, ref)
    k = _k(steps, strength)
    assert seen == list(ddim.inference_timesteps(1000, steps)[-k:])
    assert torch.equal(x0_t, _nchw(x0))  # x0 not written


def test_refine_of_the_whole_table_is_ddim_sample_from_the_noised_x0():
    # strength 1: every step, from add_noise at the first timestep
    sched = ddim.make_ddim_schedule(**NOISE_KW, device=CPU)
    x0, noise = _inputs(1)
    ts = ddim.inference_timesteps(1000, 7)
    start = ddim.add_noise(sched, _nchw(x0), _nchw(noise),
                           torch.full((2,), int(ts[0])))

    def fn(lat, cond, t):
        return 0.3 * lat + 0.2 * cond + 1e-3 * t
    out = ddim_refine(sched, fn, _nchw(x0), _nchw(noise),
                      num_inference_steps=7, strength=1.0,
                      self_condition=True)
    assert torch.equal(out, ddim_sample(sched, fn, start,
                                        num_inference_steps=7,
                                        self_condition=True))


def test_refine_graph_on_the_cpu_raises():
    sched = ddim.make_ddim_schedule(**NOISE_KW, device=CPU)
    x0, noise = _inputs(2)
    with pytest.raises(ValueError, match="CUDA latents"):
        ddim_refine(sched, lambda lat, c, t: lat, _nchw(x0), _nchw(noise),
                    num_inference_steps=4, graph=True)


@pytest.fixture(scope="module")
def tiny_unet():
    cfg = JUNetConfig(use_cross_attention=False, cond_channels=4, **UNET_KW)
    unet = JUNet(cfg)
    params = _random_params(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 4, 8, 12)),
        jnp.zeros((1,), jnp.int32)), 0)
    port = UNet2DCondition(UNetConfig(**UNET_KW))
    port.load_state_dict(unet_state_dict_from_jax(params, port.config),
                         strict=True)
    return unet, params, port.eval()


@pytest.mark.parametrize("self_condition", [False, True])
@pytest.mark.parametrize("steps,strength", CASES[:6])
def test_refine_matches_jax_on_the_tiny_unet(tiny_unet, steps, strength,
                                             self_condition):
    unet, params, port = tiny_unet
    x0, noise = _inputs(10 + steps)
    rgb = np.random.RandomState(3).randn(2, 4, 8, 4).astype(np.float32)

    def jfn(lat, cond, t):
        cond = jnp.zeros_like(lat) if cond is None else cond
        x = jnp.concatenate([lat, jnp.asarray(rgb), cond], axis=-1)
        return unet.apply(params, x, jnp.broadcast_to(t, (2,)))

    def tfn(lat, cond, t):
        cond = torch.zeros_like(lat) if cond is None else cond
        return port(torch.cat([lat, _nchw(rgb), cond], dim=1),
                    t.expand(2))

    jsched = jddim.make_ddim_schedule(**NOISE_KW)
    args = (jnp.asarray(x0), jnp.asarray(noise))
    ref = jax.jit(lambda a, b: jrefine(
        jsched, jfn, a, b, num_inference_steps=steps, strength=strength,
        self_condition=self_condition)).lower(*args).compile(
            compiler_options=FAST_XLA)(*args)
    sched = ddim.make_ddim_schedule(**NOISE_KW, device=CPU)
    with torch.no_grad():
        out = ddim_refine(sched, tfn, _nchw(x0), _nchw(noise),
                          num_inference_steps=steps, strength=strength,
                          self_condition=self_condition)
    _close(out, ref)
