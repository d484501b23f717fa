"""Export a ``main_ldm`` run to the reference's torch checkpoint format
(counterpart of ``ldmseg_tpu/tools/export_checkpoint.py``).

    python -m ldmseg_torch.tools.export_checkpoint --run_dir runs/run_0 \\
        --out model.pt [--ckpt step_1000] [--ema] [--device cpu]

Rebuilds the trainer from the run directory's ``config.json``, resumes
its newest ``step_*`` (or ``--ckpt``) checkpoint and writes the
reference's save dict, with the EMA under ``--ema``: for a ``main_ldm``
run (``--stage ldm``, the default) the stage-2 ``{step, epoch, vae_image,
vae_semseg, unet, ema?}`` after adopting the weights the run started from
(``main_ldm.load_weights``: the frozen VAEs are not in the port's
checkpoints); for a ``main_ae`` run (``--stage ae``) the stage-1 ``{'vae':
..., 'step'}``, which ``main_ldm`` reads through
``vae_model_kwargs.pretrained_path``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    """Write the export; returns its path."""
    from ..train.trainer_ae import TrainerAE
    from ..train.trainer_ldm import TrainerDiffusion
    from .main_ldm import (build_unet_config, descriptor_from_config,
                           load_weights)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run_dir", required=True,
                    help="run directory holding config.json")
    ap.add_argument("--out", required=True, help="output .pt path")
    ap.add_argument("--stage", choices=("ldm", "ae"), default="ldm")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint under checkpoints/ (default: the "
                         "newest step_*)")
    ap.add_argument("--ema", action="store_true",
                    help="export the EMA weights too")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with open(os.path.join(args.run_dir, "config.json")) as f:
        cfg = json.load(f)
    cfg["checkpoint_dir"] = os.path.join(args.run_dir, "checkpoints")
    if args.stage == "ae":
        trainer = TrainerAE(cfg, device=args.device,
                            results_folder=cfg["checkpoint_dir"])
        trainer.init_params()
    else:
        desc = descriptor_from_config(cfg)
        trainer = TrainerDiffusion(cfg,
                                   unet_config=build_unet_config(cfg, desc),
                                   device=args.device,
                                   results_folder=cfg["checkpoint_dir"],
                                   descriptor=desc)
        load_weights(trainer, cfg)
    resumed = trainer.resume(os.path.join(cfg["checkpoint_dir"], args.ckpt)
                             if args.ckpt else None)
    if resumed is None:
        raise FileNotFoundError(f"no checkpoint under "
                                f"{cfg['checkpoint_dir']}")
    trainer.export_reference(args.out, use_ema=args.ema)
    print(f"exported {args.stage} checkpoint (step {trainer.state.step}) "
          f"-> {args.out}", flush=True)
    return args.out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
