"""The port's clip training against the JAX trainer's on the CPU.

One ``forward_backward`` on a batch of two 3-frame ``SyntheticDVPS`` clips
at 64x128 with the pose net attached and ``temporal_consistency_weight``
0.1, against the JAX trainer's ``_train_step_impl`` (jitted at XLA's lowest
CPU optimisation level; a stand-in state hands back its gradients) on the
same weights, with JAX's noise and its per-clip timesteps (drawn from its
key) given to the port: the loss and the consistency term within 1e-4
relative, the UNet gradient's cosine with JAX's >= 0.999 and every leaf
within 1e-3 of the largest gradient. Then the pieces: one timestep per clip
repeated over its frames when the port draws them, the term's weight, the
pose net left without gradients, and ``train_loop`` on clips.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_torch.data import collate  # noqa: E402
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.data.video import ClipDataset  # noqa: E402
from ldmseg_torch.models.convert import unet_state_dict_from_jax  # noqa
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_clip import (  # noqa: E402
    CFG, HW, T, _one_torch_thread, _port, models)

__all__ = ["models", "_one_torch_thread"]
WEIGHT = 0.1
TRAIN_CFG = merge_dicts(CFG, {"train_kwargs": {
    "temporal_consistency_weight": WEIGHT, "video_clips": T}})


class _GradState:
    """Stands in for the JAX TrainState: ``apply_gradients`` hands back the
    gradients."""

    def __init__(self, params):
        self.params = params

    def apply_gradients(self, grads):
        return grads


def _clip_batch(n=2):
    clips = ClipDataset(SyntheticDVPS(length=6, size=HW, num_bits=5,
                                      frames_per_scene=T), clip_len=T)
    return collate([clips[i] for i in range(n)])


@pytest.fixture(scope="module")
def jax_step(models, tmp_path_factory):
    from ldmseg_tpu.parallel import make_mesh
    from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer
    from ldmseg_tpu.models.posenet import PoseExpNet as JPoseExpNet
    from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig
    from test_torch_port_clip import UNET_KW
    _, params, _ = models
    up, ip, sp, pp = params
    jtr = JTrainer(TRAIN_CFG, unet_config=JUNetConfig(
        use_cross_attention=False, cond_channels=4, **UNET_KW),
        mesh=make_mesh(devices=jax.devices()[:1]),
        results_folder=str(tmp_path_factory.mktemp("jax")))
    jtr.frozen_params = {"vae_img": ip, "vae_seg": sp}
    jtr.attach_pose(JPoseExpNet(nb_ref_imgs=T - 1), pp)
    batch = _clip_batch()
    db = {k: jnp.asarray(v) for k, v in jtr._device_batch(batch).items()}
    assert "depth" in db and "focal" in db
    key = jax.random.key(11)

    def step(p, f, b, k):
        return jtr._train_step_impl(_GradState(p), f, b, k)
    args = (up, jtr.frozen_params, db, key)
    grads, metrics, _ = jax.jit(step).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)
    # the draws of _train_step_impl (:566-612)
    keys = jax.random.split(key, 10)
    lh, lw = HW[0] // 8, HW[1] // 8
    noise = np.asarray(jax.random.normal(keys[3], (2 * T, lh, lw, 4)))
    timesteps = np.asarray(jnp.repeat(jax.random.randint(
        keys[4], (2,), jtr.min_noise_level,
        jtr.sched.num_train_timesteps), T))
    return batch, grads, metrics, noise, timesteps


def _flat(sd):
    return torch.cat([v.reshape(-1) for v in sd.values()])


def test_clip_forward_backward_matches_jax(models, jax_step):
    _, params, _ = models
    batch, grads, metrics, noise, timesteps = jax_step
    tr = _port(TRAIN_CFG, params)
    loss, ours, pred_x0 = tr.forward_backward(batch, noise=noise,
                                              timesteps=timesteps)
    assert pred_x0.shape == (2 * T, 8, 16, 4)
    cons = float(ours["consistency"])
    assert cons > 0 and float(metrics["consistency"]) > 0
    np.testing.assert_allclose(cons, float(metrics["consistency"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                               rtol=1e-4)
    ref = unet_state_dict_from_jax(grads, tr.unet_config)
    named = dict(tr.unet.named_parameters())
    g = _flat({n: named[n].grad for n in ref})
    r = _flat(ref)
    cos = float(torch.dot(g, r) / (g.norm() * r.norm()))
    assert cos >= 0.999, cos
    scale = float(r.abs().max())
    assert float((g - r).abs().max()) <= 1e-3 * scale
    # the pose net is frozen: no gradient reaches it
    assert all(p.grad is None and not p.requires_grad
               for p in tr.pose_model.parameters())


def test_clip_step_draws_one_timestep_per_clip_and_weighs_the_term(
        models, monkeypatch):
    from ldmseg_torch.train import trainer_ldm
    _, params, _ = models
    batch = _clip_batch()
    drawn = []
    real = trainer_ldm.add_noise

    def spy(sched, x, noise, t):
        drawn.append(t.clone())
        return real(sched, x, noise, t)
    monkeypatch.setattr(trainer_ldm, "add_noise", spy)
    seen = {}
    for weight in (0.0, WEIGHT):
        cfg = merge_dicts(TRAIN_CFG, {"train_kwargs": {
            "temporal_consistency_weight": weight}})
        tr = _port(cfg, params)
        drawn.clear()
        loss, metrics, _ = tr.forward_backward(
            batch, generator=torch.Generator().manual_seed(0))
        seen[weight] = (float(loss), float(metrics["consistency"]))
        # the first add_noise is the step's: [B*T] timesteps, one per clip
        t = drawn[0]
        assert t.shape == (2 * T,)
        assert torch.equal(t, t[::T].repeat_interleave(T))
    (l0, c0), (l1, c1) = seen[0.0], seen[WEIGHT]
    assert c0 == 0.0 and c1 > 0
    # the same draws: the term is added at its weight
    np.testing.assert_allclose(l1, l0 + WEIGHT * c1, rtol=1e-5)


def test_clip_train_loop_runs(models, tmp_path):
    _, params, _ = models
    ds = ClipDataset(SyntheticDVPS(length=6, size=HW, num_bits=5,
                                   frames_per_scene=T), clip_len=T)
    cfg = merge_dicts(TRAIN_CFG, {"train_kwargs": {"batch_size": 2}})
    tr = _port(cfg, params)
    tr.ds = ds
    before = {n: p.detach().clone() for n, p in tr.unet.named_parameters()}
    losses = tr.train_loop(max_steps=2, log_every=1)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert tr.state.step == 2
    moved = [not torch.equal(p.detach(), before[n])
             for n, p in tr.unet.named_parameters()
             if not n.startswith("time_embedding")]
    assert all(moved)
