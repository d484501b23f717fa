"""The port's EMA, checkpoints and best-PQ snapshot on the CPU.

- The EMA against JAX's ``TrainState`` (optax AdamW, ``ema=True``) over 4
  micro-steps with ``accumulate`` 1 and 2, the weights and gradients
  carried by ``convert.py``: within 1e-6 of max(1, max|ref|) (fp32; the
  port's one ``lerp`` pass rounds ``e + w (p - e)``, JAX's ``e d + (1 - d)
  p``).
- ``save`` -> ``resume`` restores the masters, the AdamW state, the EMA,
  the step and ``best_pq`` bit for bit; the resumed trainer's next
  ``train_step`` equals the uninterrupted one's bit for bit.
- Rotation keeps the newest 3 ``step_*`` and ``best_model``; a checkpoint
  without ``ema_params`` or ``best_pq`` resumes; ``train_loop`` saves and
  evaluates on its cadence into ``metrics.jsonl``; sampling reads the EMA.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
optax = pytest.importorskip("optax")
import torch  # noqa: E402

from ldmseg_tpu.models import torch_import as jimport  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.train import optim as joptim  # noqa: E402
from ldmseg_tpu.train.state import TrainState as JState  # noqa: E402
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa
from ldmseg_torch.train import optim  # noqa: E402
from ldmseg_torch.train.state import TrainState  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_sampling import CFG, UNET_KW  # noqa: E402

CPU = torch.device("cpu")
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
TRAIN_CFG = merge_dicts(CFG, {
    "train_kwargs": {"batch_size": 2, "clip_grad": 1.0},
    "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 0.01},
    "lr_scheduler_kwargs": {"warmup_iters": 2}, "ema_on": True,
    "ema_kwargs": {"decay": 0.9}})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    several workers at once, and torch's default pool of every core in
    each of them costs more than it gains here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unet_params():
    """The tiny UNet's JAX parameters, drawn with numpy on the port
    UNet's shapes and read into JAX's tree by its own importer
    (``unet_params_from_sd``; tracing JAX's ``init`` costs more)."""
    with torch.device("meta"):
        shapes = UNet2DCondition(UNetConfig(**UNET_KW)).state_dict()
    rng = np.random.RandomState(0)
    sd = {}
    for k, v in shapes.items():
        if k.endswith("bias"):
            sd[k] = 0.1 * rng.randn(*v.shape)
        elif v.dim() == 1:  # norm scales
            sd[k] = 1.0 + 0.1 * rng.randn(*v.shape)
        else:
            sd[k] = rng.randn(*v.shape) / np.prod(v.shape[1:]) ** 0.5
    jcfg = JUNetConfig(use_cross_attention=False, cond_channels=4, **UNET_KW)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jimport.unet_params_from_sd(sd, jcfg))


def _flat(tree):
    """The tree's leaves as one vector: this chain (clip by the global
    norm, AdamW with one decay for every leaf, the EMA) acts on each
    element alone or on the norm of all, so one leaf gives JAX's numbers
    at a fraction of the trace."""
    return {"all": np.concatenate([np.ravel(x) for x in
                                   jax.tree_util.tree_leaves(tree)])}


def _unflat(vec, like):
    leaves, treedef = jax.tree_util.tree_flatten(like)
    out, at = [], 0
    for x in leaves:
        out.append(np.asarray(vec[at:at + x.size]).reshape(x.shape))
        at += x.size
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.fixture(scope="module")
def jax_ema(unet_params):
    """JAX's ``TrainState`` at step 0 on the flattened parameters and its
    compiled ``apply_gradients`` (the EMA decay an argument), one per
    ``accumulate`` for the module."""
    tx = joptim.make_optimizer("adamw", learning_rate=1e-2, weight_decay=0.1,
                               clip_grad=1.0)
    made = {}

    def get(accumulate):
        if accumulate not in made:
            flat = _flat(unet_params)
            jstate = JState.create(flat, tx, ema=True, accumulate=accumulate)
            zeros = {"all": np.zeros_like(flat["all"])}
            # XLA's CPU backend at its lowest optimisation level: a
            # fraction of the compile time
            made[accumulate] = jstate, jax.jit(
                lambda s, g, d: s.apply_gradients(g, ema_decay=d)).lower(
                    jstate, zeros, 0.5).compile(compiler_options=FAST_XLA)
        return made[accumulate]
    return get


@pytest.mark.parametrize("accumulate,decay", [(1, 0.9), (2, 0.9),
                                               (2, 0.9999)])
def test_ema_matches_jax_train_state(accumulate, decay, unet_params,
                                     jax_ema):
    cfg = UNetConfig(**UNET_KW)
    params = unet_params
    jstate, apply = jax_ema(accumulate)
    sd = convert.unet_state_dict_from_jax(params, cfg)
    named = [(k, torch.nn.Parameter(v.clone())) for k, v in sd.items()]
    opt = optim.Optimizer(named, "adamw", learning_rate=1e-2,
                          weight_decay=0.1, clip_grad=1.0)
    state = TrainState(opt, accumulate=accumulate,
                       ema_params=[p.detach().clone() for _, p in named],
                       ema_decay=decay)
    rng = np.random.RandomState(4)
    for i in range(4):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*np.shape(x)).astype(np.float32), params)
        jstate = apply(jstate, _flat(grads), decay)
        tgrads = convert.unet_state_dict_from_jax(grads, cfg)
        for k, p in named:
            p.grad = tgrads[k].clone() if p.grad is None else \
                p.grad + tgrads[k]
        stepped = state.apply_gradients()
        assert stepped == ((i + 1) % accumulate == 0)
    assert state.step == int(jstate.step) == 4 // accumulate
    ema = convert.unet_state_dict_from_jax(
        _unflat(jstate.ema_params["all"], params), cfg)
    moved = 0
    for (k, p), e in zip(named, state.ema_params):
        ref = ema[k].numpy()
        np.testing.assert_allclose(
            e.numpy(), ref, rtol=0,
            atol=1e-6 * max(1.0, float(np.abs(ref).max())), err_msg=k)
        moved += not np.array_equal(e.numpy(), sd[k].numpy())
    assert moved > len(named) // 2


def _trainer(tmp_path=None, **over):
    ds = SyntheticDVPS(length=6, size=(32, 64), num_bits=5)
    cfg = merge_dicts(TRAIN_CFG, over)
    trainer = TrainerDiffusion(
        cfg, unet_config=UNetConfig(**UNET_KW), device=CPU, dataset=ds,
        val_dataset=SyntheticDVPS(length=2, size=(32, 64), num_bits=5),
        results_folder=None if tmp_path is None else str(tmp_path))
    trainer.init_params(seed=1)
    return trainer, ds


def _batch(ds, i):
    from ldmseg_torch.data.collate import collate
    return collate([ds[2 * i], ds[2 * i + 1]])


def _step(trainer, ds, i):
    return trainer.train_step(_batch(ds, i % 3),
                              generator=torch.Generator().manual_seed(i))


def _opt_tensors(trainer):
    sd = trainer.state.optimizer.torch_opt.state_dict()["state"]
    return {(i, k): v for i, st in sd.items() for k, v in st.items()}


def test_save_resume_is_bit_exact_and_continues(tmp_path):
    a, ds = _trainer(tmp_path)
    for i in range(2):
        _step(a, ds, i)
    a.best_pq = 12.5
    path = a.save()
    assert os.path.basename(path) == "step_2"
    _step(a, ds, 2)                   # the uninterrupted run's third step

    b, _ = _trainer(tmp_path)
    assert b.resume() == path
    ref = torch.load(path, weights_only=True)
    for n, p in b.unet.named_parameters():
        assert torch.equal(p, ref["params"][n]), n
    for (n, _), e in zip(b.unet.named_parameters(), b.state.ema_params):
        assert torch.equal(e, ref["ema_params"][n]), n
    saved = ref["opt_state"]["torch"]["state"]
    live = _opt_tensors(b)
    assert len(live) == sum(len(s) for s in saved.values()) > 0
    for (i, k), v in live.items():
        assert torch.equal(v, saved[i][k]), (i, k)
    assert b.state.step == 2 and b.best_pq == 12.5
    assert b.state.optimizer.count == 2 and b._params_pretrained

    _step(b, ds, 2)
    for (n, p), (_, q) in zip(a.unet.named_parameters(),
                              b.unet.named_parameters()):
        assert torch.equal(p, q), n
    for e, f in zip(a.state.ema_params, b.state.ema_params):
        assert torch.equal(e, f)
    for k, v in _opt_tensors(a).items():
        assert torch.equal(v, _opt_tensors(b)[k]), k


def test_rotation_keeps_three_and_the_best(tmp_path):
    t, _ = _trainer(tmp_path)
    t.save(tag="best_model")
    for s in range(1, 6):
        t.save(step=s)
    names = sorted(os.listdir(tmp_path))
    assert names == ["best_model", "metrics.jsonl", "step_3", "step_4",
                     "step_5"]
    assert t.resume().endswith("step_5")


def test_checkpoint_without_ema_or_best_pq_resumes(tmp_path):
    plain, ds = _trainer(tmp_path, ema_on=False)
    _step(plain, ds, 0)
    path = plain.save()
    data = torch.load(path, weights_only=True)
    assert "ema_params" not in data
    del data["best_pq"]
    torch.save(data, path)
    t, _ = _trainer(tmp_path)
    ema_before = [e.clone() for e in t.state.ema_params]
    t.best_pq = 3.0
    t.resume(path)
    assert t.best_pq == 3.0 and t.state.step == 1
    for e, f in zip(t.state.ema_params, ema_before):
        assert torch.equal(e, f)
    for (n, p), (_, q) in zip(t.unet.named_parameters(),
                              plain.unet.named_parameters()):
        assert torch.equal(p, q), n


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    t, _ = _trainer(tmp_path)
    assert t.resume() is None
    assert "starting fresh" in capsys.readouterr().out
    bare, _ = _trainer()
    with pytest.raises(ValueError, match="results_folder"):
        bare.save()


def test_sampling_and_calibration_read_the_ema():
    t, ds = _trainer()
    _step(t, ds, 0)
    infer = t.inference_unet()
    for (n, p), e in zip(infer.named_parameters(), t.state.ema_params):
        assert torch.equal(p, e), n
    assert not all(torch.equal(p, e) for p, e in zip(
        t.unet.parameters(), t.state.ema_params))
    off, ods = _trainer(ema_on=False)
    assert off.state.ema_params is None
    assert off.inference_unet() is off.unet


def test_train_loop_saves_evaluates_and_logs(tmp_path, monkeypatch):
    t, _ = _trainer(tmp_path)
    pqs = iter([{"pq": 10.0, "sq": 50.0, "rq": 20.0},
                {"pq": 5.0, "sq": 40.0, "rq": 12.5}])
    seen = []

    def fake_pq(save_model=False, **kw):
        seen.append((t.state.step, save_model, kw))
        res = next(pqs)
        if save_model and res["pq"] > t.best_pq:
            t.best_pq = res["pq"]
            t.save(tag="best_model")
        return res
    monkeypatch.setattr(t, "compute_pq", fake_pq)
    losses = t.train_loop(max_steps=2, log_every=1, save_every=1,
                          eval_every=2, eval_kwargs={"max_batches": 1})
    assert len(losses) == 2 and t.state.step == 2
    assert seen == [(0, True, {"max_batches": 1}),
                    (2, True, {"max_batches": 1})]
    assert sorted(os.listdir(tmp_path)) == [
        "best_model", "metrics.jsonl", "step_1", "step_2"]
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    evals = [r for r in recs if "pq" in r]
    assert [(r["step"], r["pq"], r["best_pq"]) for r in evals] == [
        (0, 10.0, 10.0), (2, 5.0, 10.0)]
    # image logging: the step's panel beside the checkpoints
    t.train_loop(max_steps=1, vis_every=1)
    assert os.path.exists(tmp_path / "rgb_gt_pred_1.jpg")


def test_compute_pq_keeps_the_best_snapshot(tmp_path):
    t, _ = _trainer(tmp_path)
    res = t.compute_pq(num_inference_steps=1, max_batches=1,
                       save_model=True)
    assert t.best_pq == res["pq"] and os.path.exists(tmp_path /
                                                     "best_model")
    os.remove(tmp_path / "best_model")
    t.compute_pq(num_inference_steps=1, max_batches=1, save_model=True)
    assert not os.path.exists(tmp_path / "best_model")
