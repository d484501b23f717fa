"""The unfused int8 UNet (``sampling_kwargs.fused_norms: False``) with
``use_packed_attention`` (K15) or ``use_absorbed_attention`` (K17) on the
model axis: two gloo ranks of the port on a ``(data=1, model=2)`` mesh
(``tests/torch_dp_workers.py:attention_axis``) with ``tensor_parallel``
and ``spatial_parallel``, against JAX's int8 trainer on a ``(1, 2)`` mesh
(its own calibration and initial noise, the same draws on both sides) and
against one process of the port. 4 heads of 8 and 16 channels: each rank
runs K15 on its 2 heads with the model group's amaxes, or K17's partial
mode on a pack of its 2 heads, through their plain versions here:

  * one int8 UNet forward on a fixed input and a calibrated 2-step int8
    ``sample_panoptic`` with each flag. JAX's int8 trainer runs K15, K17
    and K12 as the Pallas kernels in interpret mode (its wrappers would
    take their float branch on the CPU, where the port quantizes). The
    one-rank port, on JAX's calibrated scales, is held within 0.55 of the
    quantization's effect of JAX's int8 result (the yardstick of
    ``test_torch_port_model_axis_serving.py::
    test_int8_sample_with_tp_and_sp_matches_jax_and_one_rank``): the
    forward of JAX's trainer on its mesh, the sample of JAX's trainer on
    one device on the mesh's scales (see ``_check``). The mesh, on the
    one-rank port's scales, is held within 1% of the effect of one rank's
    result. ``pytest -s`` prints each distance as a share of the effect;
  * the calibrated scales on the mesh equal the one-rank ones (rtol
    1e-5, the reordered sums of the row-parallel layers);
  * each rank's K17 packs are the slice of the one-rank int8 UNet's bit
    for bit, the attentions with the flag hold the model group, and no
    rank takes a fallback of K15 or K17.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
import torch  # noqa: E402

from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_tpu.ops.pallas import geglu as jgeglu  # noqa: E402
from ldmseg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer  # noqa
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.parallel import tp  # noqa: E402
from ldmseg_torch.parallel.launch import run_ranks  # noqa: E402
from ldmseg_torch.parallel.mesh import Mesh  # noqa: E402
from ldmseg_torch.parallel.sp import model_axis  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

import torch_dp_workers as W  # noqa: E402
from test_torch_port_int8 import _kernel_close, jax_path  # noqa: E402
from test_torch_port_packed_kernels import _packed_s8_pallas  # noqa: E402
from test_torch_port_model_axis_attention import (FLAGS, UNET_KW,  # noqa
                                                  _kw)
from test_torch_port_sampling import CFG, _random_params  # noqa: E402

B, STEPS = 2, 2
UNFUSED = {"sampling_kwargs": {"int8_inference": True, "fused_norms": False},
           "train_kwargs": {"batch_size": B}}
AXIS = {"tensor_parallel": True, "spatial_parallel": True}


def _cfg(base, *over):
    cfg = merge_dicts(base, {k: CFG[k] for k in (
        "vae_model_kwargs", "image_vae_kwargs", "train_kwargs",
        "ignore_label")})
    for o in over:
        cfg = merge_dicts(cfg, o)
    return cfg


def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _interpreted(monkeypatch):
    """JAX's K15, K17 and K12 wrappers with their kernel branch on the CPU:
    the Pallas kernels in interpret mode, as the JAX package's tests run
    them (the wrappers take their float XLA branch on the CPU, where the
    port runs the kernels' int8 arithmetic); their own shape rule still
    sends the shapes the kernels do not take to that branch."""
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    jnp = jax.numpy
    packed, absorbed = (jattn.fused_self_attention_packed_s8,
                        jattn.absorbed_self_attention_s8)
    geglu = jgeglu.fused_geglu_s8

    def geglu_s8(x, w1q, s1, b1, w2q, s2, act_scale, block_t=512,
                 g_scale=None):
        b, t, c = x.shape
        if t % 8 or t % min(block_t, t):
            return geglu(x, w1q, s1, b1, w2q, s2, act_scale, block_t,
                         g_scale)
        s1t = jnp.zeros((8, s1.shape[0]), jnp.float32).at[0].set(
            s1).at[1].set(b1.astype(jnp.float32))
        s2t = jnp.zeros((8, s2.shape[0]), jnp.float32).at[0].set(s2)
        sc = jnp.zeros((8, 128), jnp.float32).at[0, 0].set(
            jnp.float32(act_scale))
        if g_scale is not None:
            sc = sc.at[0, 1].set(jnp.float32(g_scale))
        bt = min(block_t, t)
        full = [pl.BlockSpec(z.shape, lambda i, j: (0, 0))
                for z in (w1q, w2q, s1t, s2t, sc)]
        return pl.pallas_call(
            functools.partial(jgeglu._geglu_kernel,
                              static_g=g_scale is not None),
            grid=(b, t // bt),
            in_specs=[pl.BlockSpec((1, bt, c), lambda i, j: (i, j, 0))]
            + full,
            out_specs=pl.BlockSpec((1, bt, c), lambda i, j: (i, j, 0)),
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
            interpret=True)(x, w1q, w2q, s1t, s2t, sc).astype(x.dtype)

    def packed_s8(q, k, v, heads, scale, max_seq=2048):
        b, t, c = q.shape
        if t > max_seq or t % 8 or c % heads:
            return packed(q, k, v, heads, scale, max_seq)
        return _packed_s8_pallas(q, k, v, heads, scale).astype(q.dtype)

    def absorbed_s8(x, wq8, wk8, wv8, wo8, scales, heads, scale, act_scale,
                    max_seq=2048):
        b, t, c = x.shape
        d = c // heads
        if t > max_seq or t % 8 or c % heads or d % 8:
            return absorbed(x, wq8, wk8, wv8, wo8, scales, heads, scale,
                            act_scale, max_seq)
        x8 = jax.numpy.clip(jax.numpy.round(
            x.astype(jax.numpy.float32) / act_scale), -127,
            127).astype(jax.numpy.int8)
        sc = scales.at[:, 0, 4].set(jax.numpy.float32(act_scale))
        xspec = pl.BlockSpec((1, t, c), lambda i, j: (i, 0, 0))
        wspec = pl.BlockSpec((1, c, d), lambda i, j: (j, 0, 0))
        return pl.pallas_call(
            functools.partial(jattn._attn_kernel_absorbed_s8, scale=scale,
                              heads=heads),
            grid=(b, heads),
            in_specs=[xspec, wspec, wspec, wspec,
                      pl.BlockSpec((1, d, c), lambda i, j: (j, 0, 0)),
                      pl.BlockSpec((1, 8, 128), lambda i, j: (j, 0, 0))],
            out_specs=xspec,
            out_shape=jax.ShapeDtypeStruct(x.shape, jax.numpy.bfloat16),
            scratch_shapes=[pltpu.VMEM((t, c), jax.numpy.float32)],
            interpret=True)(x8, wq8, wk8, wv8, wo8, sc).astype(x.dtype)
    monkeypatch.setattr(jattn, "fused_self_attention_packed_s8", packed_s8)
    monkeypatch.setattr(jattn, "absorbed_self_attention_s8", absorbed_s8)
    monkeypatch.setattr(jgeglu, "fused_geglu_s8", geglu_s8)


def _jax_on_scales(t, scales):
    """JAX's trainer ``t`` on the int8 ``scales``: what its
    ``calibrate_int8`` sets (``trainer_ldm.py:1144-1149``)."""
    from ldmseg_tpu.ops.quant import apply_act_scales
    base, pack = t._prequant_base, t._pack_tiles
    t._int8_act_scales = scales
    t._prequant = jax.jit(lambda p: pack(apply_act_scales(base(p), scales)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmesh = jmake_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])
    jnp = jax.numpy
    k = jax.random.split(jax.random.key(0), 3)
    def jtrainer(flag, mesh, *axis):
        return JTrainer(_cfg(JAX_CONFIG, UNFUSED, *axis),
                        unet_config=JUNetConfig(use_cross_attention=False,
                                                cond_channels=4,
                                                **_kw(flag)),
                        mesh=mesh,
                        results_folder=str(tmp_path_factory.mktemp(flag)))
    jts = {flag: (jtrainer(flag, jmesh, AXIS), jtrainer(flag, None))
           for flag in FLAGS}
    jt = jts["packed"][0]
    up = _random_params(lambda: jt.unet.init(
        k[0], jnp.zeros((1, 4, 8, 12)), jnp.zeros((1,), jnp.int32)), 0)
    ip = _random_params(lambda: jt.vae_img.init(
        k[1], jnp.zeros((1, 32, 64, 3)), method=type(jt.vae_img).encode), 1)
    sp = _random_params(lambda: jt.vae_seg.init(
        {"params": k[2], "sample": k[2]}, jnp.zeros((1, 32, 64, 10)),
        sample_posterior=False), 2)
    params = jax.tree_util.tree_map(np.asarray, (up, ip, sp))
    image = np.random.RandomState(0).randn(B, 32, 64, 3).astype(np.float32)
    calib_key, sample_key = jax.random.key(1), jax.random.key(2)
    # the draws JAX's calibrate_int8 and sample_panoptic make from their keys
    calib_noise = np.asarray(jax.random.normal(calib_key, (B, 4, 8, 4)))
    init = np.asarray(jax.random.normal(sample_key, (B, 4, 8, 4)))
    # one UNet forward's input (NHWC) and timesteps
    x_fwd = np.random.RandomState(5).randn(B, 4, 8, 12).astype(np.float32)
    t_fwd = np.full((B,), 500, np.int32)
    fwd = (torch.from_numpy(x_fwd).permute(0, 3, 1, 2),
           torch.from_numpy(t_fwd).long())

    def forward(unet, dtype):
        with torch.no_grad():
            return unet(fwd[0].to(dtype), fwd[1]).float().permute(
                0, 2, 3, 1).numpy()

    def sample(tr):
        return tr.sample_panoptic({"image": image}, init_noise=init,
                                  num_inference_steps=STEPS)[1].numpy()

    one, trainers = {}, {}
    for flag in FLAGS:
        res = one[flag] = {}
        ft = TrainerDiffusion(_cfg(DEFAULT_CONFIG,
                                   {"train_kwargs": {"batch_size": B}}),
                              unet_config=UNetConfig(**_kw(flag)),
                              device="cpu")
        ft.load_jax_params(*params)
        res["float"] = sample(ft)
        res["float_forward"] = forward(ft.inference_unet(), ft.compute_dtype)
        tr = trainers[flag] = TrainerDiffusion(
            _cfg(DEFAULT_CONFIG, UNFUSED), unet_config=UNetConfig(
                **_kw(flag)), device="cpu")
        tr.load_jax_params(*params)
        res["scales"] = tr.calibrate_int8({"image": image},
                                          noise=calib_noise)
        res["forward"] = forward(tr.int8_unet(), tr.compute_dtype)
        res["int8"] = sample(tr)
        res["packs"] = W._absorbed_packs(tr.int8_unet())
    # the mesh samples on one rank's scales
    spec = {"runs": {flag: {"kind": "int8", "unet_kw": _kw(flag),
                            "cfg": _cfg(DEFAULT_CONFIG, UNFUSED, AXIS),
                            "scales": one[flag]["scales"]}
                     for flag in FLAGS},
            "params": params, "image": image, "calib_noise": calib_noise,
            "init": init, "steps": STEPS, "forward": fwd}
    ref = {}
    with ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
        spawned = pool.submit(run_ranks, W.attention_axis, 2, args=(spec,),
                              device="cpu", timeout_s=240)
        _interpreted(mp)
        for flag, (t, t1) in jts.items():
            for tr in (t, t1):
                tr.init_state({"image": image}, unet_params=up,
                              vae_img_params=ip, vae_seg_params=sp)
            scales = t.calibrate_int8({"image": image}, key=calib_key)
            # the trainer's own int8 forward: its quantized weights on its
            # calibrated scales, K15's calls recorded
            calls = []
            packed = jattn.fused_self_attention_packed_s8

            def recorded(q, k, v, heads, scale, max_seq=2048):
                out = packed(q, k, v, heads, scale, max_seq)
                calls.append([np.asarray(z, np.float32)
                              for z in (q, k, v, out)] + [heads, scale])
                return out
            mp.setattr(jattn, "fused_self_attention_packed_s8", recorded)
            y = t.unet_infer.apply(t._prequant(t.state.eval_params()),
                                   jnp.asarray(x_fwd, t.compute_dtype),
                                   jnp.asarray(t_fwd))
            mp.setattr(jattn, "fused_self_attention_packed_s8", packed)
            _jax_on_scales(t1, scales)
            ref[flag] = {"scales": scales, "k15_calls": calls,
                         "forward": np.asarray(y, np.float32)}
            for key, tr in (("mesh_x0", t), ("x0", t1)):
                ref[flag][key] = np.asarray(tr.sample_panoptic(
                    {"image": image}, sample_key,
                    num_inference_steps=STEPS)[1])
        ranks = spawned.result()
    # the one-rank port on JAX's scales
    for flag, tr in trainers.items():
        tr._int8_act_scales = {key: np.float32(ref[flag]["scales"][
            jax_path(key)]) for key in one[flag]["scales"]}
        one[flag]["jax_forward"] = forward(tr.int8_unet(), tr.compute_dtype)
        one[flag]["jax_int8"] = sample(tr)
    return {"ranks": ranks, "one": one, "jax": ref}


def _effect_and_errors(runs, flag, what):
    """The quantization's effect on ``what`` ("x0" or "forward": JAX's
    int8 result against the port's float one, relative, on the mean), the
    one-rank port's distance from JAX's int8 result on JAX's scales, and
    each rank's from the one-rank port on its scales."""
    one, ref = runs["one"][flag], runs["jax"][flag]
    key = {"x0": ("int8", "float", "jax_int8"),
           "forward": ("forward", "float_forward", "jax_forward")}[what]
    got8, gotf, on_jax = (one[k] for k in key)
    effect = _rel(ref[what], gotf)
    return effect, _rel(on_jax, ref[what]), [
        _rel(r[flag][what].numpy(), got8) for r in runs["ranks"]]


# The yardstick of test_torch_port_model_axis_serving.py::
# test_int8_sample_with_tp_and_sp_matches_jax_and_one_rank: the one-rank
# port within 0.55 of the quantization's effect from JAX's int8 trainer,
# the mesh within 1% of the effect from one rank. Each side runs on the
# same scales, and the sample's reference is JAX's trainer on one device:
# a static scale's codes flip where an input moves by an fp32 ulp next to
# a .5, and a flipped code moves an activation by a whole step (the scales
# are 0.02-0.06 here). Two calibrations an ulp apart, or JAX's own mesh
# (GSPMD gathers x before to_q/k/v and sums in another order), move a
# 2-step sample at these widths as far as the quantization does; the one
# forward holds JAX's mesh to an fp32 ulp of its one device.
def _check(runs, flag, what):
    effect, err_one, err_mesh = _effect_and_errors(runs, flag, what)
    ref = runs["jax"][flag]
    drift = (f", JAX's mesh from its one device "
             f"{_rel(ref['mesh_x0'], ref['x0']) / effect:.4g}"
             if what == "x0" else "")
    print(f"{flag} {what}: quantization's effect {effect:.6g}; one rank "
          f"from JAX {err_one / effect:.4g}, the ranks from one rank "
          f"{[e / effect for e in err_mesh]}{drift} of the effect")
    assert effect > 1e-3, "the int8 path changed nothing"
    assert err_one <= 0.55 * effect, (err_one, effect)
    for err in err_mesh:
        assert err <= 0.01 * effect, (err, effect)
    ranks = runs["ranks"]
    assert ranks[0][flag][what].shape == runs["jax"][flag][what].shape
    assert torch.equal(ranks[0][flag][what], ranks[1][flag][what])


@pytest.mark.parametrize("flag", list(FLAGS))
def test_int8_sample_with_the_flag_matches_jax_and_one_rank(runs, flag):
    _check(runs, flag, "x0")
    for r in runs["ranks"]:
        assert bool(torch.isfinite(r[flag]["logits"]).all())
        # K15 and K17 take every site (T = 32 and 8, d = 8 and 16)
        assert r[flag]["fallbacks"][2:] == [0, 0]


@pytest.mark.parametrize("flag", list(FLAGS))
def test_int8_forward_with_the_flag_matches_jax_and_one_rank(runs, flag):
    _check(runs, flag, "forward")


@pytest.mark.parametrize("flag", list(FLAGS))
def test_calibrated_scales_on_the_mesh_equal_one_rank(runs, flag):
    one, ref = runs["one"][flag]["scales"], runs["jax"][flag]["scales"]
    for r in runs["ranks"]:
        ours = r[flag]["scales"]
        assert ours.keys() == one.keys()
        assert {jax_path(k) for k in ours} == set(ref)
        for key, value in ours.items():
            np.testing.assert_allclose(value, one[key], rtol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("flag", list(FLAGS))
def test_the_attentions_hold_a_ranks_heads(runs, flag):
    attn = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    mid = "mid_block.attentions.0.transformer_blocks.0.attn1"
    whole = runs["one"][flag]["packs"]
    for rank, r in enumerate(runs["ranks"]):
        res = r[flag]
        assert {attn, mid} <= res["grouped"]
        if flag == "packed":
            assert not res["packs"] and not whole
            continue
        ax = model_axis(Mesh(model=2, model_rank=rank))
        cuts = {"w_qkv": (0, 3), "wo_q": (1, 1), "w_scale": (1, 1),
                "wo_p": (1, 1)}
        assert res["packs"].keys() == whole.keys() and whole
        for name, want in whole.items():
            got = res["packs"][name]
            field = name.rsplit(".", 1)[-1]
            if field == "heads":
                assert got * 2 == want
                continue
            want = tp.local_tensor(want, *cuts[field][:1], ax,
                                   cuts[field][1])
            assert got.dtype == want.dtype and torch.equal(got, want), name


def test_k15_in_the_int8_forward_matches_jax_call_by_call(runs):
    """K15's plain version on the q, k and v that each K15 call of JAX's
    int8 forward on its mesh received, against that call's output (the
    Pallas kernel in interpret mode): K15's tolerance of
    ``test_torch_port_packed_kernels.py`` at the UNet's own inputs."""
    calls = runs["jax"]["packed"]["k15_calls"]
    assert len(calls) == 4   # down 0, mid, up 1 (two): T = 32, 8, 32, 32
    for q, k, v, ref, heads, scale in calls:
        out = S8.fused_self_attention_packed_s8_reference(
            *(torch.from_numpy(z) for z in (q, k, v)), heads,
            scale).float().numpy()
        print(f"K15 {q.shape}: {np.mean(out == ref):.6f} of the outputs "
              f"bit-equal to JAX's, max |diff| {np.abs(out - ref).max()}")
        _kernel_close(out, ref, mean_tol=2.5e-3)
