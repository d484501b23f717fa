"""The dataset presets and the dataset construction that the stage-2 CLIs
share (own copy of ``ldmseg_tpu/tools/main_ae.py:DATASET_PRESETS`` and
``build_datasets``).

The stage-1 seg-VAE trainer is not ported (``ROADMAP.md`` queue 8), so
``python -m ldmseg_torch.tools.main_ae`` raises.
"""

from __future__ import annotations

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
    raise NotImplementedError(
        "main_ae: the stage-1 seg-VAE trainer is not ported yet (ROADMAP.md "
        "queue 8)")


if __name__ == "__main__":
    main()
