"""Conditioning descriptors (counterpart of
``ldmseg_tpu/models/descriptors.py``; reference ldmseg/models/descriptors.py:
67-105): what the UNet's cross-attention reads.

- ``remove``: no cross-attention at all (the default,
  tools/configs/base/base.yaml:71);
- ``none``: cross-attention on a context the caller supplies
  (``batch["context"]``);
- ``learnable``: learnable object queries inside the UNet;
- ``clip`` / ``clipproj``: a frozen CLIP vision tower over the frame
  (``transformers.CLIPVisionModel``), its hidden states through the UNet's
  ``encoder_hid_proj``;
- ``text``: a frozen CLIP text tower over the caption's tokens
  (``transformers.CLIPTextModel`` + ``CLIPTokenizer``).

The CLIP towers load from a local ``pretrained_path`` only (nothing is
downloaded); without one they raise JAX's ``ValueError``. ``transformers``
is imported only in those branches. The port also takes the spec's kind
names ``clip_vision`` and ``clip_text`` for ``clip`` and ``text``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class DescriptorSpec:
    """A resolved conditioning option, read by the LDM trainer.
    ``encoder_hid_dim``: the width of the tower's hidden states that
    ``encoder_hid_proj`` takes (the vision tower's ``hidden_size``)."""

    kind: str  # 'remove' | 'none' | 'learnable' | 'clip_vision' | 'clip_text'
    use_cross_attention: bool
    num_object_queries: int = 0
    encoder_hid_dim: int = 0
    model: Optional[Any] = None
    tokenizer: Optional[Any] = None


def get_image_descriptors(name: Optional[str] = "remove",
                          pretrained_path: Optional[str] = None,
                          num_queries: int = 77,
                          hidden_dim: int = 768) -> DescriptorSpec:
    """Resolve a conditioning mode (JAX ``get_image_descriptors``). A CLIP
    vision tower's ``encoder_hid_dim`` is its ``hidden_size``; JAX sets
    ``hidden_dim`` and lets ``nn.Dense`` infer the input width."""
    if name == "remove":
        return DescriptorSpec(kind="remove", use_cross_attention=False)
    if name in (None, "none"):
        return DescriptorSpec(kind="none", use_cross_attention=True)
    if name == "learnable":
        return DescriptorSpec(kind="learnable", use_cross_attention=True,
                              num_object_queries=num_queries)
    if name in ("clip", "clipproj", "clip_vision"):
        if pretrained_path is None:
            raise ValueError(
                "CLIP descriptors need local pretrained weights "
                "(zero-egress environment; pass pretrained_path)")
        from transformers import CLIPVisionModel
        model = CLIPVisionModel.from_pretrained(pretrained_path,
                                                local_files_only=True)
        return DescriptorSpec(
            kind="clip_vision", use_cross_attention=True,
            encoder_hid_dim=int(getattr(model.config, "hidden_size",
                                        hidden_dim)), model=model)
    if name in ("text", "clip_text"):
        if pretrained_path is None:
            raise ValueError(
                "text descriptors need local pretrained weights "
                "(zero-egress environment; pass pretrained_path)")
        from transformers import CLIPTextModel, CLIPTokenizer
        tok = CLIPTokenizer.from_pretrained(pretrained_path,
                                            local_files_only=True)
        model = CLIPTextModel.from_pretrained(pretrained_path,
                                              local_files_only=True)
        return DescriptorSpec(kind="clip_text", use_cross_attention=True,
                              model=model, tokenizer=tok)
    raise NotImplementedError(f"descriptor {name!r}")
