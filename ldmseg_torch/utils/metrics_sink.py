"""The metrics sink: one JSON object a line in ``metrics.jsonl`` (counterpart
of ``ldmseg_tpu/utils/metrics_sink.py``, its scalar records
``{"step", "time", <scalars>}``, and ``{"step", "time", "image": {"name",
"ref"}}`` pointing at a saved panel). The JAX sink mirrors to wandb on
request; the card has no wandb, so ``use_wandb=True`` raises."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsSink:
    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        if use_wandb:
            raise NotImplementedError(
                "wandb: True: the port logs to metrics.jsonl only (no wandb "
                "where it runs)")
        self.path = path
        self.file = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.file = open(path, "a")

    def log(self, step: int, **scalars) -> None:
        if self.file is None:
            return
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items() if v is not None}}
        self.file.write(json.dumps(rec) + "\n")
        self.file.flush()

    def log_image(self, step: int, name: str, image, caption=None) -> None:
        """Record a visualization panel: ``image`` is a saved panel's path
        (an array is recorded as ``<array name>``)."""
        if self.file is None:
            return
        ref = image if isinstance(image, str) else f"<array {name}>"
        self.file.write(json.dumps({"step": int(step), "time": time.time(),
                                    "image": {"name": name, "ref": ref}})
                        + "\n")
        self.file.flush()

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None
