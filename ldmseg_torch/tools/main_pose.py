"""Pose-net training from the command line (counterpart of
``ldmseg_tpu/tools/main_pose.py``), stage 3 of the fork's plan.

    python -m ldmseg_torch.tools.main_pose [datasets=synthetic]
        [train_kwargs.batch_size=4] [clip_len=3] [output_dir=runs_pose]
        [run_idx=0] [data_prefix=...] [device=cpu] [key.sub=value ...]

Trains :class:`~..models.posenet.PoseExpNet` (with the explainability
decoder) on ``clip_len``-frame clips of the dataset's train split with the
SfMLearner photometric objective, on the card unless ``device=cpu``, and
writes ``<run>/checkpoints/step_N`` (``torch.save`` of ``{params,
nb_ref}``): hand it to stage 2 with ``pose_model_kwargs.pretrained_path``
in ``main_ldm`` (the temporal-consistency term and pose-warped clip
sampling) or ``predict clips=``.
"""

from __future__ import annotations

import sys

from .main_ae import DATASET_PRESETS, build_datasets


def main(argv=None):
    """Train and save; returns the trainer."""
    from ..data.video import ClipDataset
    from ..train.trainer_pose import TrainerPose
    from ..utils.config import (load_config, merge_dicts,
                                parse_dot_overrides, prepare_config)

    from ..parallel.multihost import initialize_from_env

    overrides = parse_dot_overrides(sys.argv[1:] if argv is None else argv)
    dataset = overrides.pop("datasets", "synthetic")
    config_path = overrides.pop("config", None)
    prefix = overrides.pop("data_prefix", None)
    output_dir = overrides.pop("output_dir", "runs_pose")
    run_idx = overrides.pop("run_idx", -1)
    clip_len = int(overrides.pop("clip_len", 3))
    device = overrides.pop("device", "cuda")
    # one rank a GPU under torchrun or SLURM; one process without them
    device = initialize_from_env(device=device)["device"]

    cfg = load_config(config_path)
    cfg = merge_dicts(cfg, DATASET_PRESETS.get(dataset, {}))
    cfg = merge_dicts(cfg, overrides)
    cfg = prepare_config(cfg, output_dir, run_idx)
    print(f"Run dir: {cfg['output_dir']}", flush=True)

    train_ds, _ = build_datasets(cfg, prefix)
    clips = ClipDataset(train_ds, clip_len=clip_len)
    print(f"{len(clips)} clips of {clip_len} frames", flush=True)

    trainer = TrainerPose(cfg, dataset=clips,
                          results_folder=cfg["checkpoint_dir"],
                          nb_ref_imgs=clip_len - 1, device=device)
    trainer.train_loop()
    path = trainer.save(step=trainer.train_num_steps)
    print(f"Pose checkpoint: {path}", flush=True)
    print("Hand off to stage 2 with "
          f"pose_model_kwargs.pretrained_path={path} "
          f"pose_model_kwargs.nb_ref_imgs={clip_len - 1}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
