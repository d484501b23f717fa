"""The port's ``parallel/`` package (``multihost.py``, ``mesh.py``,
``launch.py``) against the JAX package's ``parallel/`` and evaluators, on
the CPU:

  * ``initialize_from_env``'s reading of explicit arguments, torchrun's and
    SLURM's variables (no process group needed), and its no-op in one
    process;
  * ``make_mesh``'s shapes, layout and refusals, ``shard_batch``'s rows and
    its refusal of a batch ``data`` does not divide, ``zero1_partition``;
  * one spawn of 2 gloo ranks: ``all_gather_host``, ``replicate``, the
    PQ and mIoU sums (two evaluators on disjoint shards, summed, score as
    one port evaluator and as JAX's ``PanopticEvaluator``/``SemsegMeter``
    on the whole set, as ``tests/test_multihost_sync.py`` does for JAX),
    the segmentation warp term over the global valid count as JAX's on the
    whole batch, and Adafactor under ZeRO-1 bit-equal to one process;
  * a rank that raises fails ``run_ranks`` with its traceback, one that
    outlives the deadline is killed, and none is left running;
  * ``spatial_parallel``/``tensor_parallel`` take effect with a model axis
    (and none without one);
  * ``entry.dryrun_multichip(2, "cpu")``: stages A and D (B and C need 4
    ranks); ``rank_seed`` keys on the data rank, so the model ranks of one
    data index draw alike;
  * the slice's modules, and the ranks' helper, import no JAX.
"""

import multiprocessing
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldmseg_tpu.evals.miou import SemsegMeter as JSemsegMeter
from ldmseg_tpu.evals.pq import PanopticEvaluator as JEvaluator
from ldmseg_torch import evals as E
from ldmseg_torch.parallel import mesh as M
from ldmseg_torch.parallel import multihost as MH
from ldmseg_torch.parallel.launch import run_ranks
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

import torch_dp_workers as W
from test_torch_port_evals import _scene
from test_torch_port_package import FORBIDDEN, _imported_roots

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, so one a spawned rank (``run_ranks`` shares
    the caller's): the suite runs several workers at once, and ranks with
    a pool of threads each spin against all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# the data-parallel slice's modules, one case each
PARALLEL_MODULES = ["parallel", "parallel.mesh", "parallel.multihost",
                    "parallel.tp", "parallel.sp",
                    "parallel.launch", "entry", "train.optim", "train.state",
                    "train.trainer_ae", "train.trainer_pose",
                    "losses.point_losses", "losses.pose_consistency",
                    "evals.pq", "evals.miou", "tools.main_ae",
                    "tools.main_pose"]


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []


def test_a_rank_loads_no_jax():
    # what a spawned rank imports: the package and the ranks' helper
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import ldmseg_torch.parallel, ldmseg_torch.entry, "
            "ldmseg_torch.train.trainer_ae, ldmseg_torch.train.trainer_pose, "
            "torch_dp_workers; "
            f"bad = {{m.split('.')[0] for m in sys.modules}} & "
            f"{set(FORBIDDEN)!r}; print(bad, file=sys.stderr); "
            "sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

# ---------------------------------------------------------------------------
# the rendezvous a process joins
# ---------------------------------------------------------------------------
CLUSTERS = {
    "explicit": (dict(coordinator_address="10.0.0.1:1234", num_processes=4,
                      process_id=3, environ={"LOCAL_RANK": "1"}),
                 ("tcp://10.0.0.1:1234", 4, 3, 1)),
    "explicit_url": (dict(coordinator_address="file:///tmp/s",
                          num_processes=2, process_id=0, local_rank=0,
                          environ={}), ("file:///tmp/s", 2, 0, 0)),
    "torchrun": (dict(environ={"RANK": "5", "WORLD_SIZE": "8",
                               "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
                               "MASTER_PORT": "4242"}),
                 ("tcp://h0:4242", 8, 5, 1)),
    "torchrun_one": (dict(environ={"RANK": "0", "WORLD_SIZE": "1"}),
                     ("tcp://localhost:29500", 1, 0, 0)),
    "slurm": (dict(environ={"SLURM_NTASKS": "8", "SLURM_PROCID": "6",
                            "SLURM_LOCALID": "2",
                            "SLURM_NODELIST": "gpu[03-04,9],cpu1"}),
              ("tcp://gpu03:29500", 8, 6, 2)),
    "slurm_master": (dict(environ={"SLURM_NTASKS": "2", "SLURM_PROCID": "1",
                                   "SLURM_NODELIST": "a1",
                                   "MASTER_ADDR": "b2",
                                   "MASTER_PORT": "77"}),
                     ("tcp://b2:77", 2, 1, 0)),
}


@pytest.mark.parametrize("case", list(CLUSTERS))
def test_cluster_from_env(case):
    kw, (url, n, rank, local) = CLUSTERS[case]
    assert MH.cluster_from_env(**kw) == {
        "init_method": url, "world_size": n, "rank": rank,
        "local_rank": local}


def test_nothing_describes_a_cluster():
    # a single SLURM task is no cluster, as JAX's SLURM_NTASKS > 1 rule
    for env in ({}, {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
                {"WORLD_SIZE": "2"}):
        assert MH.cluster_from_env(environ=env) is None
    with pytest.raises(ValueError, match="num_processes"):
        MH.cluster_from_env("h:1", environ={})
    assert MH.first_slurm_host("node7") == "node7"


def test_initialize_from_env_is_a_no_op_in_one_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    info = MH.initialize_from_env(device="cpu")
    assert info == {"process_id": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1, "device": "cpu"}
    assert not torch.distributed.is_initialized()
    assert MH.is_main_process() and MH.world_size() == 1
    assert MH.all_gather_host({"a": 1}) == [{"a": 1}]
    assert MH.broadcast_host(3) == 3


# ---------------------------------------------------------------------------
# the mesh, batch shards and the ZeRO-1 partition
# ---------------------------------------------------------------------------
def _fake_world(monkeypatch, rank, world):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))


@pytest.mark.parametrize("rank,world,num_data,num_model,want", [
    (3, 4, None, 1, (4, 1, 3, 0, None)),
    (3, 4, 2, 2, (2, 2, 1, 1, ((1, 3), (2, 3)))),
    (2, 4, None, 2, (2, 2, 1, 0, ((0, 2), (2, 3)))),
    (1, 4, 1, 4, (1, 4, 0, 1, ((1,), (0, 1, 2, 3)))),
])
def test_make_mesh_layout(monkeypatch, rank, world, num_data, num_model,
                          want):
    _fake_world(monkeypatch, rank, world)
    mesh = M.make_mesh(num_data, num_model)
    assert (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank) == \
        want[:4]
    if want[4] is not None:  # rank = data index x model + model index
        assert (mesh.data_group, mesh.model_group) == want[4]
    assert mesh.shape == {"data": want[0], "model": want[1]}


def test_make_mesh_refusals(monkeypatch):
    assert M.make_mesh() == M.Mesh()
    with pytest.raises(ValueError, match="needs an initialised"):
        M.make_mesh(num_data=2)
    _fake_world(monkeypatch, 0, 4)
    with pytest.raises(ValueError, match="over a world of 4"):
        M.make_mesh(num_data=3)
    with pytest.raises(ValueError, match="does not split over 2"):
        M.Mesh(data=2).local_batch(5)


def test_shard_batch_rows():
    mesh = M.Mesh(data=3, data_rank=1)
    batch = {"image": np.arange(12).reshape(6, 2),
             "t": torch.arange(6), "meta": list("abcdef"), "scale": 2.0}
    out = M.shard_batch(mesh, batch)
    np.testing.assert_array_equal(out["image"], [[4, 5], [6, 7]])
    assert out["t"].tolist() == [2, 3] and out["meta"] == ["c", "d"]
    assert out["scale"] == 2.0
    np.testing.assert_array_equal(M.shard_batch(M.Mesh(), batch["image"]),
                                  batch["image"])
    with pytest.raises(ValueError, match="image: leading size 5"):
        M.shard_batch(mesh, {"image": np.zeros((5, 2))})


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_zero1_partition(n):
    rng = np.random.RandomState(n)
    params = [torch.empty(int(s)) for s in rng.randint(1, 5000, 300)]
    params += [torch.empty(3, 3, 320, 320), torch.empty(7, dtype=torch.int8)]
    owner = M.zero1_partition(params, n)
    assert len(owner) == len(params) and set(owner) <= set(range(n))
    loads = [sum(p.numel() * p.element_size()
                 for p, o in zip(params, owner) if o == r) for r in range(n)]
    largest = max(p.numel() * p.element_size() for p in params)
    assert max(loads) <= sum(loads) / n + largest
    assert M.zero1_partition(params, n) == owner  # a fixed rule


# ---------------------------------------------------------------------------
# two gloo ranks: the collectives and the evaluators' sums
# ---------------------------------------------------------------------------
PQ_KW = dict(thing_ids={11, 12, 13}, ignore_label=0)


def _warp_inputs(b=4, hw=(16, 32)):
    """Bits, depth, poses and focals whose last two rows (the second
    rank's) translate far enough that most pixels leave the frame, on
    constant maps that agree however warped: the ranks' valid counts and
    their disagreement differ."""
    rng = np.random.RandomState(5)
    bits = (rng.rand(2, b, *hw, 6) > 0.5).astype(np.float32) * 2 - 1
    bits[:, 2:] = 1.0  # constant maps: warped, they still agree
    depth = (2.0 + np.floor(rng.rand(b, *hw) * 64) / 2).astype(np.float32)
    pose = np.zeros((b, 6), np.float32)
    pose[:, :3] = [[0.25, -0.125, 0.5], [-0.5, 0.0625, 0.25],
                   [3.0, 0.5, 0.5], [-2.5, 1.0, 0.25]]
    focal = np.array([16.0, 32.0, 24.0, 20.0], np.float32)
    return bits[0], bits[1], depth, pose, focal


@pytest.fixture(scope="module")
def two_ranks():
    rng = np.random.RandomState(4)
    shards = [[_scene(rng)[:2] for _ in range(3)] for _ in range(2)]
    spec = {"tags": ["a", "b"], "pq_kw": PQ_KW, "num_classes": 14,
            "ignore": 0, "images": shards, "warp": _warp_inputs()}
    return spec, run_ranks(W.collectives, 2, args=(spec,), device="cpu",
                           timeout_s=120)


def test_two_ranks_take_the_warp_term_over_the_global_valid_count(
        two_ranks):
    import jax.numpy as jnp
    from ldmseg_tpu.losses.pose_consistency import \
        segmentation_consistency_loss as jwarp
    spec, ranks = two_ranks
    ref = float(jwarp(*map(jnp.asarray, spec["warp"])))
    for out in ranks:
        assert out["warp"]["global"] == pytest.approx(ref, rel=1e-5)
        # each rank's own count: another loss
        assert abs(out["warp"]["own"] - ref) > 100 * 1e-5 * ref


def test_two_ranks_sum_the_evaluators_as_one_process(two_ranks):
    spec, ranks = two_ranks
    shards = spec["images"]
    whole = [im for shard in shards for im in shard]
    one, ref = E.PanopticEvaluator(**PQ_KW), JEvaluator(**PQ_KW)
    meter = E.SemsegMeter(14, ignore_index=0)
    jmeter = JSemsegMeter(14, ignore_index=0)
    for pred, gt in whole:
        one.add_image(pred, gt)
        ref.add_image(pred, gt)
        meter.update(pred[None], gt[None])
        jmeter.update(pred[None], gt[None])
    want, jwant = one.evaluate(), ref.evaluate(synchronize=False)
    for r, out in enumerate(ranks):
        assert out["gathered"] == [{"rank": 0, "tag": "a"},
                                   {"rank": 1, "tag": "b"}]
        # the data group's first rank's values, on both
        assert torch.equal(out["t"], torch.full((3, 2), 5.0))
        assert torch.equal(out["w"], torch.ones(3, 2))
        got = out["pq"]
        for res in (want, jwant):
            assert (got["tp"], got["fp"], got["fn"]) == (
                res["tp"], res["fp"], res["fn"]) and got["tp"] > 0
            # IoU sums are added rank by rank: fp64 to its last bits
            for k in ("pq", "sq", "rq", "iou_sum"):
                assert got[k] == pytest.approx(res[k], rel=1e-12), k
        assert set(out["per_class"]) == set(want["per_class"])
        for c, st in want["per_class"].items():
            mine = out["per_class"][c]
            assert [mine[k] for k in ("tp", "fp", "fn")] == \
                [st[k] for k in ("tp", "fp", "fn")]
            assert mine["pq"] == pytest.approx(st["pq"], rel=1e-12)
        # the counts are integers: exact
        np.testing.assert_array_equal(out["inter"], meter.inter)
        np.testing.assert_array_equal(out["union"], meter.union)
        np.testing.assert_array_equal(out["inter"], jmeter.inter)
        assert out["miou"] == meter.return_score()["mIoU"]


def test_zero1_adafactor_is_exact_and_repartitions(two_ranks):
    # whole parameters keep Adafactor's factored moments exact: the same
    # gradients on 2 ranks give the one-process masters and state bit for
    # bit, through a state dict gathered onto rank 0 and loaded again; the
    # other rank keeps no copy of it
    _, ranks = two_ranks
    one = W.adafactor_steps()
    got = ranks[0]["adafactor"]["state"]
    assert got["count"] == one["state"]["count"] == 2
    assert set(got["factored"]) == set(one["state"]["factored"])
    for i, st in one["state"]["factored"].items():
        for k, v in st.items():
            assert torch.equal(got["factored"][i][k], v), (i, k)
    assert all(out["adafactor"]["state"] is None for out in ranks[1:])
    for out in ranks:
        got = out["adafactor"]
        for n, p in one["masters"].items():
            assert torch.equal(got["masters"][n], p), n
    shares = [r["adafactor"]["state_bytes"] for r in ranks]
    assert sum(shares) == one["state_bytes"] and min(shares) > 0


@pytest.mark.parametrize("worker,timeout_s,match", [
    (W.fail_on, 60, "(?s)rank 1:.*ValueError: from rank 1"),
    (W.hang_on, 8, r"rank 1: exit code -9 \(killed: the deadline of 8 s")],
    ids=["raises", "hangs"])
def test_a_failed_rank_fails_the_launch_and_leaves_none_running(
        worker, timeout_s, match):
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match=match):
        run_ranks(worker, 2, args=(1,), device="cpu", timeout_s=timeout_s)
    assert set(multiprocessing.active_children()) <= before


def test_run_ranks_defaults_to_the_card_and_refuses_without_one(
        monkeypatch):
    # the caller asks for the CPU; leaving the device out asks for CUDA,
    # which raises before any rank starts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="device 'cuda' asked for"):
        run_ranks(W.fail_on, 2, args=(1,), timeout_s=8)
    assert set(multiprocessing.active_children()) <= before


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_one_rank_state_dict_is_torchs_own_layout(name):
    # the optimizer's state dict is torch's: state by index in the grouped
    # order, param_groups with their keys and index lists, on the CPU
    from ldmseg_torch.train.optim import Optimizer
    gen = torch.Generator().manual_seed(0)
    named = [(n, torch.nn.Parameter(torch.randn(s, generator=gen)))
             for n, s in [("a.weight", (6, 5)), ("a.bias", (5,)),
                          ("norm.weight", (5,)), ("b.weight", (4, 3))]]
    opt = Optimizer(named, name, learning_rate=1e-2, weight_decay=0.1,
                    weight_decay_norm=0.0, weight_decay_bias=0.0)
    for _, p in named:
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    ours, torchs = opt.state_dict(), opt.torch_opt.state_dict()
    assert ours["count"] == 1
    assert ours["torch"]["param_groups"] == torchs["param_groups"]
    assert len(ours["torch"]["param_groups"]) == 2  # decay and no decay
    assert set(ours["torch"]["state"]) == set(torchs["state"])
    for i, st in torchs["state"].items():
        assert set(ours["torch"]["state"][i]) == set(st)
        for k, v in st.items():
            got = ours["torch"]["state"][i][k]
            if isinstance(v, torch.Tensor):
                assert got.device.type == "cpu" and torch.equal(got, v)
            else:
                assert got == v


# ---------------------------------------------------------------------------
# the trainer's model-axis options
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["spatial_parallel", "tensor_parallel"])
def test_model_axis_options_refused_with_a_model_axis(key):
    # no longer refused: with a model axis of 2 each takes effect (a mesh
    # without a group: the cut and the class swaps need no collective)
    from ldmseg_torch.entry import DRYRUN_UNET, _dryrun_config
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.parallel import sp, tp
    cfg = merge_dicts(_dryrun_config(1, "cpu"), {key: True})
    unet_config = UNetConfig(in_channels=12, **DRYRUN_UNET)
    trainer = TrainerDiffusion(cfg, unet_config=unet_config, device="cpu",
                               mesh=M.Mesh(model=2))
    trainer.init_params(seed=0)
    assert getattr(trainer, key)
    halos = [isinstance(m, sp.SpatialConv2d)
             for v in (trainer.vae_img, trainer.vae_seg)
             for m in v.modules() if isinstance(m, torch.nn.Conv2d)]
    lay = tp.layout(trainer.unet)
    if key == "tensor_parallel":
        assert lay and not any(halos)
        assert set(trainer.state.optimizer.sharded) == {True, False}
    else:
        assert not lay and halos and all(halos)
    # no model axis: JAX's has_spatial_axis rule, no effect
    one = TrainerDiffusion(cfg, unet_config=unet_config, device="cpu")
    assert one.mesh.model == 1 and not getattr(one, key)


def test_rank_seed_keys_on_the_data_rank():
    # the model ranks of one data index share their draws
    seeds = {(d, m): M.rank_seed(0, M.Mesh(2, 2, d, m)) for d in range(2)
             for m in range(2)}
    assert seeds[(0, 0)] == seeds[(0, 1)] != seeds[(1, 0)] == seeds[(1, 1)]
    assert M.rank_seed(5, M.Mesh(1, 2, 0, 1)) == 5


def test_dryrun_multichip_stages_a_and_d_on_two_cpu_ranks(capsys):
    from ldmseg_torch.entry import dryrun_multichip
    ranks = dryrun_multichip(2, "cpu", timeout_s=240)
    text = capsys.readouterr().out
    assert "A: DP train step" in text and "D: pose-consistent" in text
    assert "B, C: need 4 ranks" in text
    for out in ranks:
        assert len(out["A"]["losses"]) == 2  # accumulate 2: one step
        assert out["A"]["logits"] == (2, 32, 64, 24)  # 2 frames a rank
        assert out["D"]["consistency"] > 0
    # ZeRO-1: the two ranks hold about half the state each
    a, b = (r["A"]["state_bytes"] for r in ranks)
    assert 0.45 < a / (a + b) < 0.55


def test_dryrun_multichip_stages_b_and_c_on_four_cpu_ranks(capsys):
    # a (2, 2) mesh: B holds the TP UNet to the replicated one (JAX's
    # 1e-2; fp32 on the CPU agrees far closer), C takes a TP + ZeRO-1 + SP
    # step with each rank holding about a quarter of the optimizer state
    from ldmseg_torch.entry import dryrun_multichip
    ranks = dryrun_multichip(4, "cpu", timeout_s=240)
    text = capsys.readouterr().out
    assert "B: (data=2, model=2)" in text and "C: TP+ZeRO-1+SP" in text
    total = sum(r["C"]["state_bytes"] for r in ranks)
    for out in ranks:
        b = out["B"]
        assert max(b["fwd_err"], b["grad_err"]) < 1e-4
        assert 0.5 < b["param_share"] < 0.55
        assert np.isfinite(out["C"]["loss"]) and out["C"]["sp_stages"] == 2
        assert 0.2 < out["C"]["state_bytes"] / total < 0.3
        assert len(out["A"]["losses"]) == 2 and out["D"]["consistency"] > 0
