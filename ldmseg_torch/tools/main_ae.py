"""Stage-1 seg-VAE training from the command line (counterpart of
``ldmseg_tpu/tools/main_ae.py``), and the dataset presets and dataset
construction that the stage-2 CLIs share.

    python -m ldmseg_torch.tools.main_ae [datasets=synthetic]
        [output_dir=runs_ae] [run_idx=0] [config=path.yaml]
        [data_prefix=...] [device=cpu] [key.sub=value ...]

Composes the config (defaults, a YAML file, the dataset preset, the dot
overrides), makes the run directory (``<output_dir>/run_<idx>`` with its
``config.json``), builds :class:`~..train.trainer_ae.TrainerAE` on the card
(``device=cpu`` for the plain PyTorch path) with seeded random weights,
resumes from the newest ``step_*`` checkpoint of the run, evaluates mIoU
and PQ on 2 val batches (unless ``eval_first=False``; ``eval_only=True``
evaluates the whole val set and stops), trains to
``train_kwargs.train_num_steps``, saves and prints the mIoU on 8 val
batches. ``export_checkpoint --stage ae --run_dir <run dir>`` then writes
the reference's ``{'vae': ...}`` file that ``main_ldm`` reads through
``vae_model_kwargs.pretrained_path``.
"""

from __future__ import annotations

import sys

DATASET_PRESETS = {
    # the reference's dataset config groups (tools/configs/datasets/*.yaml)
    "kitti": {"train_db_name": "kitti", "val_db_name": "kitti",
              "num_classes": 30, "num_bits": 5, "ignore_label": 0,
              "vae_model_kwargs": {"in_channels": 10, "out_channels": 128}},
    "cityscapes": {"train_db_name": "cityscapes",
                   "val_db_name": "cityscapes", "num_classes": 128,
                   "num_bits": 16, "ignore_label": 127,
                   "vae_model_kwargs": {"in_channels": 16,
                                        "out_channels": 128}},
    "synthetic": {"train_db_name": "synthetic", "val_db_name": "synthetic",
                  "num_classes": 32, "num_bits": 5, "ignore_label": 0,
                  "vae_model_kwargs": {"in_channels": 10,
                                       "out_channels": 32}},
}


def build_datasets(cfg: dict, prefix: str | None,
                   val_kwargs: dict | None = None):
    """The train and val datasets of ``cfg``: 64 and 16 synthetic frames,
    or the named reader under ``prefix`` (train with the flip of
    ``transformation_kwargs.flip``). ``val_kwargs`` extends the val dataset
    only (``image_only=True`` for frames without ground truth); the
    synthetic dataset ignores it."""
    from ..data import get_dataset
    name = cfg["train_db_name"]
    tk = cfg["transformation_kwargs"]
    kwargs = dict(num_bits=cfg["num_bits"], ignore_label=cfg["ignore_label"],
                  size=(tk["size"], tk["size_2"]))
    if name == "synthetic":
        train = get_dataset("synthetic", length=64, num_classes=20, **kwargs)
        val = get_dataset("synthetic", length=16, num_classes=20, **kwargs)
        return train, val
    kwargs["num_classes"] = cfg["num_classes"]
    kwargs["normalize_params"] = (
        tk.get("normalize_params") if tk.get("normalize", True)
        else {"mean": [0.0, 0.0, 0.0], "std": [1.0, 1.0, 1.0]})
    train = get_dataset(name, prefix=prefix, split="train",
                        flip=tk.get("flip", True), **kwargs)
    val = get_dataset(cfg["val_db_name"], prefix=prefix, split="val",
                      **kwargs, **(val_kwargs or {}))
    return train, val


def main(argv=None):
    """Run the stage-1 pipeline; returns the trainer."""
    from ..train.trainer_ae import TrainerAE
    from ..utils.config import (load_config, merge_dicts,
                                parse_dot_overrides, prepare_config)

    from ..parallel.multihost import initialize_from_env

    overrides = parse_dot_overrides(sys.argv[1:] if argv is None else argv)
    dataset = overrides.pop("datasets", "synthetic")
    config_path = overrides.pop("config", None)
    prefix = overrides.pop("data_prefix", None)
    output_dir = overrides.pop("output_dir", "runs_ae")
    run_idx = overrides.pop("run_idx", -1)
    device = overrides.pop("device", "cuda")
    # one rank a GPU under torchrun or SLURM; one process without them
    device = initialize_from_env(device=device)["device"]

    cfg = load_config(config_path)
    cfg = merge_dicts(cfg, DATASET_PRESETS.get(dataset, {}))
    cfg = merge_dicts(cfg, overrides)
    cfg = prepare_config(cfg, output_dir, run_idx)
    print(f"Run dir: {cfg['output_dir']}", flush=True)

    train_ds, val_ds = build_datasets(cfg, prefix)
    trainer = TrainerAE(cfg, device=device, dataset=train_ds,
                        val_dataset=val_ds,
                        results_folder=cfg["checkpoint_dir"])
    trainer.init_params()
    trainer.resume()

    if cfg.get("eval_only"):
        print(trainer.compute_miou(), flush=True)
        print(trainer.compute_pq(), flush=True)
        return trainer
    if cfg.get("eval_first", True):
        print("step-0 eval:", trainer.compute_metrics(max_batches=2),
              flush=True)
    remaining = trainer.train_num_steps - trainer.state.step
    if remaining > 0:
        trainer.train_loop(max_steps=remaining)
    trainer.save()
    print(trainer.compute_miou(max_batches=8), flush=True)
    return trainer


if __name__ == "__main__":
    main()
