"""Stage-2 data parallelism against the JAX package: two gloo ranks of the
port (``ldmseg_torch/parallel``) against JAX's ``TrainerDiffusion`` on a
2-device ``make_mesh(num_data=2)`` of the conftest's virtual CPU devices,
with the same weights and the same global draws (each rank takes its rows of
the draws JAX makes from its key), all in fp32, tiny UNet, global batch 4:

  * the loss (the data group's mean) to 1e-5 relative, the reduced
    gradients to 1e-4 of each tensor's largest entry, the masters after the
    AdamW step to 1e-3 x lr: with ZeRO-1 off and on, with ``accumulate: 2``
    and ``clip_grad`` over two optimizer steps, and with ``ohem_ratio: 0.5``
    (where the ranks' own top-k is shown to miss JAX's loss);
  * a ZeRO-1 checkpoint written by 2 ranks is the one-rank layout, equal to
    the checkpoint of the same 2 ranks without ZeRO, close to the one of
    one process on the global batch, and resumes on 1 and on 2 ranks to
    the same next step.

The ranks run ``tests/torch_dp_workers.py`` (no JAX there) in one spawn for
every case.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ldmseg_tpu.parallel import shard_batch as jshard  # noqa: E402
from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer  # noqa
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.parallel.launch import run_ranks  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

import torch_dp_workers as W  # noqa: E402
from test_torch_port_sampling import CFG, UNET_KW, _random_params  # noqa

CPU = torch.device("cpu")
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
B, HW, LAT = 4, (32, 64), (4, 8)
LR = 1e-3
BASE = {"train_kwargs": {"batch_size": B},
        "lr_scheduler_name": "none",
        "optimizer_kwargs": {"lr": LR, "weight_decay": 0.01}}
CASES = {
    "base": {},
    "accumulate_clip": {"train_kwargs": {"accumulate": 2, "clip_grad": 0.05}},
    "ohem": {"train_kwargs": {"ohem_ratio": 0.5}},
}
ZERO = {"optimizer_zero_redundancy": True}


def _cfg(base, case, zero1):
    """CFG's tiny widths on ``base`` (either package's defaults), then
    BASE, the case and ZeRO-1."""
    cfg = merge_dicts(base, {k: CFG[k] for k in (
        "vae_model_kwargs", "image_vae_kwargs", "train_kwargs",
        "ignore_label")})
    for over in (BASE, CASES[case], ZERO if zero1 else {}):
        cfg = merge_dicts(cfg, over)
    return cfg


def _capture(tx):
    """``tx`` that also keeps the gradients of its last update in its
    state (the mean over the micro-batches, before clipping)."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


def _draws(key):
    """The noise and timesteps ``_train_step_impl`` draws from ``key``."""
    keys = jax.random.split(key, 10)
    return {"noise": np.asarray(jax.random.normal(keys[3], (B,) + LAT + (4,))),
            "timesteps": np.asarray(jax.random.randint(keys[4], (B,), 0,
                                                       1000))}


@pytest.fixture(scope="module")
def setup():
    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **UNET_KW))
    up = _random_params(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 4, 8, 12)),
        jnp.zeros((1,), jnp.int32)), 0)
    ivae = JImageVAE(decoder_enabled=False, **CFG["image_vae_kwargs"])
    ip = _random_params(lambda: ivae.init(
        jax.random.key(1), jnp.zeros((1, 32, 64, 3)),
        method=JImageVAE.encode), 1)
    svk = {k: v for k, v in CFG["vae_model_kwargs"].items()
           if k != "pretrained_path"}
    svk["block_out_channels"] = tuple(svk["block_out_channels"])
    svae = JSegVAE(**svk)
    sp = _random_params(lambda: svae.init(
        {"params": jax.random.key(2), "sample": jax.random.key(2)},
        jnp.zeros((1, 32, 64, 10)), sample_posterior=False), 2)
    params = jax.tree_util.tree_map(np.asarray, (up, ip, sp))
    ds = SyntheticDVPS(length=4 * B, size=HW, num_bits=5)
    keys = [jax.random.key(10 + i) for i in range(4)]
    micro = [({k: np.stack([ds[i * B + j][k] for j in range(B)])
               for k in ("image", "image_semseg", "semseg")}, keys[i])
             for i in range(4)]
    return params, micro


def _jax_run(params, micro, case, tmp):
    mesh = jmake_mesh(num_data=2)
    jt = JTrainer(_cfg(JAX_CONFIG, case, True),
                  unet_config=JUNetConfig(use_cross_attention=False,
                                          cond_channels=4, **UNET_KW),
                  mesh=mesh, results_folder=str(tmp))
    jt.tx = _capture(jt.tx)
    up, ip, sp = params
    jt.init_state(micro[0][0], unet_params=up, vae_seg_params=sp,
                  vae_img_params=ip)
    step, out = None, {"loss": [], "t_mean": [], "grads": []}
    # the compiled step's outputs may come out otherwise sharded than its
    # inputs; each step's state is put on the shardings it was compiled for
    for batch, key in micro:
        db = jshard(mesh, jt._device_batch(batch))
        if step is None:
            step = jt._train_step.lower(jt.state, jt.frozen_params, db,
                                        key).compile(
                compiler_options=FAST_XLA)
        before = int(jt.state.step)
        jt.state, metrics, _ = step(
            jax.device_put(jt.state, step.input_shardings[0][0]),
            jt.frozen_params, db, key)
        out["loss"].append(float(metrics["loss"]))
        out["t_mean"].append(float(metrics["timestep_mean"]))
        if int(jt.state.step) != before:
            out["grads"].append(jax.tree_util.tree_map(
                np.asarray, jt.state.opt_state[1]))
    out["params"] = jax.tree_util.tree_map(np.asarray, jt.state.params)
    return out


# micro-batches each case runs: one optimizer step, or two of 2 micro-batches
N_MICRO = {"base": 1, "accumulate_clip": 4, "ohem": 1}


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The port's run of every case on 2 ranks (one spawn, in a thread
    while JAX compiles): each case with ZeRO-1 on, ``base`` also without
    it, and the checkpoint cases; JAX's run of each case."""
    params, micro = setup
    tmp = tmp_path_factory.mktemp("dp_train")
    glob = [(b, _draws(k)) for b, k in micro]
    specs = {}
    for c in CASES:
        for zero1 in ((False, True) if c == "base" else (True,)):
            specs[(c, zero1)] = {
                "cfg": _cfg(DEFAULT_CONFIG, c, zero1),
                "unet_kw": UNET_KW, "params": params,
                "micro": glob[:N_MICRO[c]]}
    ck = {z: str(tmp / f"ck_{z}") for z in (False, True)}
    for z in (False, True):  # two steps, a checkpoint after the first
        specs[("ckpt", z)] = dict(specs[("base", z)], micro=glob[:2],
                                  save_after=1, folder=ck[z])
    specs[("resume", True)] = dict(
        specs[("base", True)], micro=glob[1:2], folder=ck[True],
        resume=f"{ck[True]}/dp_checkpoint")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, W.stage2_all, 2,
                              args=(list(specs.values()),), device="cpu",
                              timeout_s=240)
        jax_out = {c: _jax_run(params, micro[:N_MICRO[c]], c, tmp / c)
                   for c in CASES}
        ranks = spawned.result()
    for c, out in jax_out.items():  # the draws are JAX's
        np.testing.assert_allclose(
            out["t_mean"], [d["timesteps"].mean()
                            for _, d in glob[:N_MICRO[c]]], rtol=1e-6)
    port = {key: [r[i] for r in ranks] for i, key in enumerate(specs)}
    return {"jax": jax_out, "port": port, "glob": glob, "params": params,
            "ck": ck}


def _port_tree(tree):
    return convert.unet_state_dict_from_jax(tree, UNetConfig(**UNET_KW))


def _check_against_jax(runs, case, zero1):
    ref = runs["jax"][case]
    r0, r1 = runs["port"][(case, zero1)]
    np.testing.assert_allclose(r0["means"], ref["loss"], rtol=1e-5)
    assert r0["means"] == r1["means"]
    assert len(r0["grads"]) == len(ref["grads"]) > 0
    for ours, theirs in zip(r0["grads"], ref["grads"]):
        theirs = _port_tree(theirs)
        for n, g in ours.items():
            scale = float(theirs[n].abs().max())
            np.testing.assert_allclose(g.numpy(), theirs[n].numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=n)
    new = _port_tree(ref["params"])
    jgrads = [_port_tree(g) for g in ref["grads"]]
    for n, p in r0["masters"].items():
        assert torch.equal(p, r1["masters"][n]), n  # the ranks agree
        # 1e-3 x lr, plus what the gradients' difference (held above)
        # moves AdamW's update g / (|g| + eps) where |g| is at that
        # difference's level: 2 |dg| / (|g| + eps) a step
        cond = sum(2.0 * np.abs(g[n].numpy() - j[n].numpy())
                   / (np.maximum(np.abs(g[n].numpy()), np.abs(j[n].numpy()))
                      + 1e-8) for g, j in zip(r0["grads"], jgrads))
        err = np.abs(p.numpy() - new[n].numpy())
        bound = LR * (1e-3 + cond)
        assert (err <= bound).all(), (n, float(err.max()),
                                      int((err > 1e-3 * LR).sum()))


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
def test_two_ranks_step_as_jax_mesh(runs, zero1):
    _check_against_jax(runs, "base", zero1)
    r0, r1 = runs["port"][("base", zero1)]
    # AdamW's two moments and step count a parameter
    one_rank = sum(p.numel() * 4 * 2 + 4 for p in r0["masters"].values())
    if zero1:  # split by whole parameters
        assert r0["state_bytes"] + r1["state_bytes"] == one_rank
        assert 0.45 < r0["state_bytes"] / one_rank < 0.55
    else:
        assert r0["state_bytes"] == r1["state_bytes"] == one_rank


def test_accumulate_and_clip_reduce_before_clipping(runs):
    # two optimizer steps of two micro-batches each; clip_grad 0.05 scales
    # both steps' global gradients, so the second AdamW step shows it
    _check_against_jax(runs, "accumulate_clip", True)
    grads = runs["port"][("accumulate_clip", True)][0]["grads"]
    norms = [float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in step.values()]))) for step in grads]
    assert len(grads) == 2 and min(norms) > 0.05  # the clip acts


def test_ohem_takes_the_global_top_k(runs):
    _check_against_jax(runs, "ohem", True)
    r0 = runs["port"][("ohem", True)][0]
    ref = runs["jax"]["ohem"]["loss"][0]
    # the ranks' own top-k, averaged, is not JAX's loss
    assert abs(r0["per_rank_ohem"][0] - ref) > 100 * 1e-5 * abs(ref)


def _one_process(runs, micro, resume=None):
    tr = TrainerDiffusion(_cfg(DEFAULT_CONFIG, "base", False),
                          unet_config=UNetConfig(**UNET_KW), device=CPU)
    tr.load_jax_params(*runs["params"])
    if resume:
        tr.resume(resume)
    for batch, d in micro:
        tr.forward_backward(batch, noise=d["noise"],
                            timesteps=d["timesteps"])
        tr.state.apply_gradients()
    return tr


def _close(a, b, tol=1e-6):
    bound = tol * max(1.0, float(b.abs().max()))
    assert float((a - b).abs().max()) <= bound


def test_zero1_checkpoint_is_the_one_rank_layout_and_resumes(runs):
    glob, ck = runs["glob"], runs["ck"]
    zero = torch.load(f"{ck[True]}/dp_checkpoint", weights_only=True)
    plain = torch.load(f"{ck[False]}/dp_checkpoint", weights_only=True)
    # the same reduced gradients: ZeRO-1 changes where the state lives only
    assert zero["step"] == plain["step"] == 1
    for n, v in zero["params"].items():
        assert torch.equal(v, plain["params"][n]), n
    zs, ps = zero["opt_state"], plain["opt_state"]
    assert zs["count"] == ps["count"] == 1
    assert zs["torch"]["param_groups"] == ps["torch"]["param_groups"]
    assert set(zs["torch"]["state"]) == set(ps["torch"]["state"])
    for i, st in zs["torch"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ps["torch"]["state"][i][k]), (i, k)
    # one process on the global batch: the same layout, values to fp32
    one = _one_process(runs, glob[:1])
    sd = one.state.optimizer.state_dict()
    assert sd["torch"]["param_groups"] == zs["torch"]["param_groups"]
    assert set(sd["torch"]["state"]) == set(zs["torch"]["state"])
    for i, st in sd["torch"]["state"].items():
        for k, v in st.items():
            _close(zs["torch"]["state"][i][k], v)
    # two steps straight on, and from the checkpoint on 2 ranks: bit-equal;
    # on 1 rank: to fp32
    straight = runs["port"][("ckpt", True)][0]["masters"]
    resumed = runs["port"][("resume", True)]
    assert resumed[0]["step"] == 2
    for n, p in straight.items():
        assert torch.equal(resumed[0]["masters"][n], p), n
        assert torch.equal(runs["port"][("ckpt", False)][0]["masters"][n],
                           p), n
    solo = _one_process(runs, glob[1:2], resume=f"{ck[True]}/dp_checkpoint")
    assert solo.state.step == 2
    for n, p in solo.unet.named_parameters():
        _close(p.detach(), straight[n], 1e-5)
