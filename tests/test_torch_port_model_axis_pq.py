"""``TrainerDiffusion.compute_pq`` on a model axis: two gloo ranks of the
port on a ``(data=1, model=2)`` mesh with ``tensor_parallel``
(``tests/torch_dp_workers.py:compute_pq_axis``), each sampling the whole
val set (one data rank) with 2 DDIM steps on the TP UNet, against one
process of the port on the same weights: the PQ, its parts and the
per-class sums equal on both ranks and equal one process's (integers
exactly, floats within 1e-12), with segments found and scored (the seg
decoder's last convolution sharpened alike on both sides, since random
weights give flat logits; its segments match none of the ground truth's,
so the false-positive and false-negative counts carry the check). The
evaluator sums over the data group, a group of one rank
here: the model ranks never add each other's counts.
"""

import numpy as np
import pytest

from ldmseg_torch.data import KittiDVPS
from ldmseg_torch.models.unet import UNetConfig
from ldmseg_torch.parallel.launch import run_ranks
from ldmseg_torch.tools.kitti_tree import write_kitti_dvps_tree
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

import torch_dp_workers as W
from test_torch_port_evals import _same_results

SIZE, STEPS, SEED, SHARPEN = (32, 64), 2, 5, 8.0
CFG = merge_dicts(DEFAULT_CONFIG, {
    "vae_model_kwargs": {
        "in_channels": 10, "int_channels": 16, "out_channels": 24,
        "block_out_channels": [8, 8, 16, 16], "num_upscalers": 2,
        "upscale_channels": 16, "norm_num_groups": 8},
    "image_vae_kwargs": {"block_out_channels": [8, 8, 16, 16], "groups": 8},
    "train_kwargs": {"self_condition": True, "weight_dtype": "float32",
                     "batch_size": 2},
    "eval_kwargs": {"mask_th": 0.5, "count_th": 20, "overlap_th": 0.5},
    "ignore_label": 0,
})
UNET_KW = dict(in_channels=12, out_channels=4, block_out_channels=(16, 32),
               attn_down=(True, False), layers_per_block=1,
               attention_head_dim=2, norm_num_groups=4,
               use_fused_attention=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_dvps_tree(root, "val", frames=3, hw=(45, 110), scenes=1,
                          seed=12)
    spec = {"root": root, "size": SIZE, "unet_kw": UNET_KW, "seed": SEED,
            "steps": STEPS, "sharpen": SHARPEN,
            "cfg": merge_dicts(CFG, {"tensor_parallel": True})}
    ranks = run_ranks(W.compute_pq_axis, 2, args=(spec,), device="cpu",
                      timeout_s=180)
    ds = KittiDVPS(prefix=root, split="val", size=SIZE,
                   keep_fullres_gt=True)
    tr = TrainerDiffusion(CFG, unet_config=UNetConfig(**UNET_KW),
                          device="cpu", val_dataset=ds)
    tr.init_params(seed=SEED)
    W._sharpen_seg_decoder(tr, SHARPEN)
    return {"ranks": ranks, "one": tr.compute_pq(num_inference_steps=STEPS)}


@pytest.mark.parametrize("rank", [0, 1])
def test_compute_pq_on_a_model_axis_equals_one_process(runs, rank):
    one = runs["one"]
    # random weights: the predicted segments match none of the ground
    # truth's (PQ 0), so the counts carry the check
    assert one["fp"] > 0 and one["fn"] > 0 and one["per_class"]
    assert np.isfinite(one["pq"])
    _same_results(runs["ranks"][rank], one)
