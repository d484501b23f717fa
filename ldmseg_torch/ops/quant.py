"""Int8 inference: weight and activation quantization, the s8 convolution,
the int8 UNet's weight preparation and its per-site calibration.

Counterpart of ``ldmseg_tpu/ops/quant.py``: ``quantize_weight`` (:98),
``quantize_activation`` (:106), the s8 convolution ``_s8_conv`` (:36) and
``QuantConv`` (:448) and ``QuantDense`` (:406) on prequantized weights
(:class:`QuantConv2d`, :class:`QuantLinear` after ``prepare``) and on their
float weights through ``int8_conv`` (:73-95) and ``int8_dot`` (:381-403),
whose backward is the float conv's or matmul's gradient (straight-through:
training through int8, :class:`Int8ConvSTE`, :class:`Int8LinearSTE`),
``prequantize_conv_tree`` (:132) with ``pack_inference_tiles`` (:243), and
``calibrate_act_scale_tree``/``apply_act_scales`` (:549, :633), and the
VAE half of ``prequantize_conv_tree`` (:func:`prepare_int8_vae`).

Rounding is half-to-even (``torch.round``), as ``jnp.round``. Scales are
float32 and computed in the JAX package's order, so the int8 codes and the
scales equal its trees bit for bit.

The s8 convolution gathers the nine shifted views of the padded int8 input
into an ``[B*Ho*Wo, 9*Cin]`` matrix and multiplies it with the
``[Cout, 9*Cin]`` weight codes in ``torch._int_mm``: int8 x int8 with int32
sums on the CPU and on the card. The JAX package runs this convolution in
XLA, not in Pallas, so a library product stands in for it. Its channel
split for ``Cin % 128 == 64`` (:54-57) works around an XLA emitter on the
TPU and is exact by linearity; the port leaves it out.

The weight preparation reads the fp32 masters, as the JAX trainer
quantizes its fp32 parameter tree, and writes int8 codes, float32 scales
and the kernels' operands into the int8 UNet's modules
(:func:`prepare_int8_unet`). It runs once per sampling call, outside the
step loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in both types)."""
    return float(np.float32(x))


def quantize_weight(w: torch.Tensor, dims, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes with one scale per index of the dimensions not
    in ``dims``: ``scale = max(amax, 1e-8) / 127``, ``q = round(w / scale)``
    in float32 (``quantize_weight`` :98 reduces the HWIO axes 0-2, i.e.
    per output channel). With ``group`` (the model group's reductions,
    ``parallel/tp.py:ModelGroup``) ``w`` holds a slice along ``dims`` (a
    row-parallel layer's input channels) and the amax is the whole
    tensor's, the maximum over the group."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=dims, keepdim=True)
    if group is not None:
        amax = group.max(amax)
    scale = amax.clamp_min(1e-8) / 127.0
    return torch.round(wf / scale).to(torch.int8), scale.flatten()


def quantize_rows(linear: nn.Linear) -> Tuple[torch.Tensor, torch.Tensor]:
    """A linear's weight ``[out, in]`` quantized per output row. A
    row-parallel layer (``parallel/tp.py:RowLinear``) holds a slice of each
    row: the whole row's amax comes from its ``tp_group``, so the codes and
    scales are the slice of the one-rank ones."""
    return quantize_weight(linear.weight, dims=(1,),
                           group=getattr(linear, "tp_group", None))


def quantize_activation(x: torch.Tensor, act_scale=None):
    """Per-tensor symmetric int8 quantize: the static ``act_scale`` (made
    float32; a 0-d tensor is taken as it is) or, when it is None,
    ``max(amax, 1e-8) / 127`` of ``x`` (a 0-d tensor, no host sync).
    Returns ``(codes, scale)``."""
    xf = x.float()
    if act_scale is None:
        scale = dynamic_scale(xf.abs().amax())
    elif isinstance(act_scale, torch.Tensor):
        scale = act_scale
    else:
        scale = f32(act_scale)
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale


def dynamic_scale(amax: torch.Tensor) -> torch.Tensor:
    """The dynamic per-tensor scale of :func:`quantize_activation` from a
    tensor's amax: ``max(amax, 1e-8) / 127`` in float32."""
    return amax.float().clamp_min(1e-8) / 127.0


def int8_matmul(a: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b_rows[N, K]ᵀ int8 -> [M, N] int32`` with exact
    int32 sums (``torch._int_mm``). On the card ``_int_mm`` wants M > 16
    and K, N multiples of 8: zero rows and columns make up the shape
    (exact)."""
    m, k = a.shape
    n = b_rows.shape[0]
    if a.device.type == "cuda":
        pad_k, pad_n = -k % 8, -n % 8
        if pad_k:
            a, b_rows = F.pad(a, (0, pad_k)), F.pad(b_rows, (0, pad_k))
        if m <= 16:
            a = F.pad(a, (0, 0, 0, 17 - m))
        if pad_n:
            b_rows = F.pad(b_rows, (0, 0, 0, pad_n))
        return torch._int_mm(a, b_rows.t())[:m, :n]
    return torch._int_mm(a.contiguous(), b_rows.t())


def exact_int8_matmul(a: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """The same product for the kernels' plain versions, any shape and
    batch: float64 holds every int32 sum of int8 products exactly."""
    return torch.matmul(a.double(), b_rows.double().transpose(-1, -2)).to(
        torch.int32)


Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def pad_pairs(padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``padding`` as JAX's ``((top, bottom), (left, right))``."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def s8_conv2d(x_q: torch.Tensor, w_mat: torch.Tensor, stride: int,
              padding: Padding = 1) -> torch.Tensor:
    """3x3 conv of int8 NCHW ``x_q`` with the ``[Cout, 9*Cin]`` codes (taps
    major, then input channels) -> int32 NHWC ``[B, Ho, Wo, Cout]``.
    ``padding`` is an int or JAX's ``((top, bottom), (left, right))`` (the
    image VAE's downsample: ``((0, 1), (0, 1))``), zero codes."""
    b, cin, h, w = x_q.shape
    s = stride
    (pt, pb), (pl, pr) = pad_pairs(padding)
    xp = F.pad(x_q.permute(0, 2, 3, 1), (0, 0, pl, pr, pt, pb))
    ho = (h + pt + pb - 3) // s + 1
    wo = (w + pl + pr - 3) // s + 1
    cols = torch.stack([xp[:, i:i + s * (ho - 1) + 1:s,
                           j:j + s * (wo - 1) + 1:s]
                        for i in range(3) for j in range(3)], dim=3)
    y = int8_matmul(cols.reshape(b * ho * wo, 9 * cin), w_mat)
    return y.reshape(b, ho, wo, -1)


class Int8ConvSTE(torch.autograd.Function):
    """``int8_conv`` (:73-95): the 3x3 s8 conv (symmetric ``padding``) of
    ``x`` NCHW with ``w`` quantized per output channel and ``x`` per tensor
    (``act_scale`` or its amax), ``float(s8) * (xs * ws)`` in ``x``'s dtype;
    the backward is the float conv's (``w`` cast to ``x``'s dtype)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, act_scale: Optional[float],
                padding: int = 1):
        q, ws = quantize_weight(w, dims=(1, 2, 3))
        x_q, xs = quantize_activation(x, act_scale)
        y = s8_conv2d(x_q, q.permute(0, 2, 3, 1).reshape(q.shape[0], -1),
                      stride, padding)
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        y = (y.float() * (xs * ws)).to(x.dtype)
        return y.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wx = w.to(x.dtype)
        gx = torch.nn.grad.conv2d_input(x.shape, wx, g, ctx.stride,
                                        ctx.padding)
        gw = torch.nn.grad.conv2d_weight(x, w.shape, g, ctx.stride,
                                         ctx.padding)
        return gx, gw.to(w.dtype), None, None, None


class Int8LinearSTE(torch.autograd.Function):
    """``int8_dot`` (:381-403): ``x [..., in]`` per tensor, ``w [out, in]``
    per output row, ``int32 x8·w8ᵀ`` dequantized in ``x``'s dtype; the
    backward is the float matmul's (``w`` cast to ``x``'s dtype)."""

    @staticmethod
    def forward(ctx, x, w, act_scale: Optional[float]):
        q, ws = quantize_weight(w, dims=(1,))
        x_q, xs = quantize_activation(x, act_scale)
        y = int8_matmul(x_q.reshape(-1, x.shape[-1]), q)
        ctx.save_for_backward(x, w)
        y = y.reshape(*x.shape[:-1], w.shape[0])
        return (y.float() * (xs * ws)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.to(x.dtype)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return gx, gw.to(w.dtype), None


class QuantConv2d(nn.Conv2d):
    """3x3 conv, the int8 ``QuantConv`` (:448), with a stride and
    ``padding`` (an int, or JAX's ``((top, bottom), (left, right))``: the
    image VAE's downsample pads ``((0, 1), (0, 1))``). Its float
    ``weight`` and ``bias`` are the float conv's (the same keys). After
    :meth:`prepare` (``QuantConv`` with a ``{"q", "scale"}`` kernel) it runs
    on int8 codes and float32 per-output-channel scales in buffers filled
    from a float conv's weights: the input is quantized per tensor with the
    calibrated ``x_scale`` when set, else the module's ``act_scale``, else
    its own amax, ``y = float(s8 conv) * (x_scale * w_scale)`` cast to the
    input dtype, plus the bias. Unprepared, it runs :class:`Int8ConvSTE` on
    its own weight (training through int8, as ``QuantConv`` on a float
    kernel).

    The input may also be K6's ``(q int8 [B, Cin, H, W], s float32 [B])``
    (``int8_fuse_gn``, :478-486): the s8 conv runs on those codes and ``y =
    float(s8 conv) * (s[b] * w_scale)`` is cast to bf16 whatever the compute
    dtype, plus the bias; ``x_scale`` and ``act_scale`` are not read."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act_scale: Optional[float] = None, padding: Padding = 1):
        pairs = pad_pairs(padding)
        even = pairs[0][0] == pairs[0][1] == pairs[1][0] == pairs[1][1]
        super().__init__(in_channels, out_channels, 3, stride=stride,
                         padding=pairs[0][0] if even else 0)
        self.s8_stride = stride
        self.s8_padding = pairs
        # an uneven padding is applied to the float input of the
        # straight-through path (zeros quantize to zero codes)
        (pt, pb), (pl, pr) = pairs
        self.float_pad = None if even else (pl, pr, pt, pb)
        self.act_scale = act_scale
        self.x_scale: Optional[float] = None
        self.register_buffer("w_q", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    def prepare(self, src: nn.Conv2d) -> None:
        q, s = quantize_weight(src.weight, dims=(1, 2, 3))
        self.w_q = q.permute(0, 2, 3, 1).reshape(self.out_channels,
                                                 -1).contiguous()
        self.w_scale = s

    def weight_codes(self) -> torch.Tensor:
        """The codes as a conv weight ``[Cout, Cin, 3, 3]``."""
        return self.w_q.reshape(self.out_channels, 3, 3,
                                self.in_channels).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_q is None:
            if isinstance(x, tuple):
                raise RuntimeError("QuantConv2d: K6's codes need prepared "
                                   "weights (run prepare_int8_unet)")
            if self.float_pad is not None:
                x = F.pad(x, self.float_pad)
            y = Int8ConvSTE.apply(x, self.weight, self.s8_stride,
                                  self.act_scale, self.padding[0])
            return y + self.bias.to(y.dtype)[:, None, None]
        if isinstance(x, tuple):
            x_q, s = x
            y = s8_conv2d(x_q, self.w_q, self.s8_stride, self.s8_padding)
            scale = s[:, None, None, None] * self.w_scale
            y = (y.float() * scale).to(torch.bfloat16)
            y = y + self.bias.to(y.dtype)
            return y.permute(0, 3, 1, 2).contiguous()
        return self.s8_forward(x, self.site_scale())

    def site_scale(self) -> Optional[float]:
        """The input's static scale: the calibrated ``x_scale``, else
        ``act_scale``; None: its dynamic amax."""
        return self.x_scale if self.x_scale is not None else self.act_scale

    def s8_forward(self, x: torch.Tensor, scale, padding=None
                   ) -> torch.Tensor:
        """The prepared path on a float ``x``: quantized with ``scale`` (a
        float, a 0-d tensor, or None for its amax), the s8 conv with
        ``padding`` (default the module's), ``float(s8 conv) * (xs *
        w_scale)`` in x's dtype, the bias; NCHW."""
        x_q, xs = quantize_activation(x, scale)
        y = s8_conv2d(x_q, self.w_q, self.s8_stride,
                      self.s8_padding if padding is None else padding)
        y = (y.float() * (xs * self.w_scale)).to(x.dtype)
        y = y + self.bias.to(y.dtype)
        return y.permute(0, 3, 1, 2).contiguous()


class QuantLinear(nn.Linear):
    """``QuantDense`` (:406), the float linear's keys. On a prequantized
    ``{"q", "scale"}`` leaf (:422-436, after :meth:`prepare`): int8 codes
    ``[out, in]`` and float32 per-output-channel scales in buffers filled
    from a float ``nn.Linear``; the input is quantized per tensor with the
    calibrated ``x_scale`` when set, else ``act_scale``, else its own amax
    (clipped); ``y = float(int32 x8·W8ᵀ)·(xs·w_scale)`` cast to the input
    dtype, plus the bias. Unprepared, :class:`Int8LinearSTE` on its own
    weight (``int8_dot``)."""

    def __init__(self, in_features: int, out_features: int,
                 act_scale: Optional[float] = None):
        super().__init__(in_features, out_features)
        self.act_scale = act_scale
        self.x_scale: Optional[float] = None
        self.register_buffer("w_q", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    def prepare(self, src: nn.Linear) -> None:
        self.w_q, self.w_scale = quantize_rows(src)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_q is None:
            y = Int8LinearSTE.apply(x, self.weight, self.act_scale)
            return y + self.bias.to(y.dtype)
        site = self.x_scale if self.x_scale is not None else self.act_scale
        x_q, xs = quantize_activation(x, site)
        y = int8_matmul(x_q.reshape(-1, self.in_features), self.w_q)
        y = y.reshape(*x.shape[:-1], self.out_features)
        y = (y.float() * (xs * self.w_scale)).to(x.dtype)
        return y + self.bias.to(y.dtype)


# ---------------------------------------------------------------------------
# weight preparation (prequantize_conv_tree + pack_inference_tiles)
# ---------------------------------------------------------------------------
def quantize_head_weights(wq, wk, wv, wo, heads: int):
    """``attention.py:quantize_head_weights`` (:451) on torch ``Linear``
    weights ``[out, in]``: one scale per head for each of the four
    projections (rows of head h of ``to_q/k/v``, columns of head h of
    ``to_out``). Returns the codes in the same layout and ``scales [4, H]``
    float32. Under tensor parallelism the weights hold this rank's heads:
    ``to_q/k/v`` ``[ci, C]``, ``to_out`` ``[C, ci]``, ``heads`` of them."""
    d = wq.shape[0] // heads
    codes, scales = [], []
    for w in (wq, wk, wv):
        q, s = quantize_weight(w.reshape(heads, d, -1), dims=(1, 2))
        codes.append(q.reshape(w.shape))
        scales.append(s)
    q, s = quantize_weight(wo.reshape(wo.shape[0], heads, d), dims=(0, 2))
    codes.append(q.reshape(wo.shape))
    scales.append(s)
    return (*codes, torch.stack(scales))


def quantize_fullc_weights(wq, wk, wv, wo):
    """``attention.py:quantize_fullc_weights`` (:594) on torch ``Linear``
    weights ``[out, in]``: one scale per tensor, ``max(amax, 1e-8) / 127``,
    for each of the four. Returns the codes in the same layout and ``scales
    [4]`` float32. The JAX function also pads ``to_out``'s head rows to 128
    with zeros (``wop [H, 128, C]``), TPU layout that the port does not
    store."""
    codes, scales = [], []
    for w in (wq, wk, wv, wo):
        q, s = quantize_weight(w, dims=(0, 1))
        codes.append(q)
        scales.append(s)
    return (*codes, torch.cat(scales))


@torch.no_grad()
def prepare_int8_unet(int8_unet: nn.Module, masters: nn.Module,
                      absorbed_attention: bool = False) -> None:
    """Fill ``int8_unet`` (a UNet built with the int8 flags) from the float
    UNet ``masters`` of the same shape: the float parameters are copied
    (cast to the int8 UNet's dtype), the s8 convs, the s8 linears and the
    int8 transformer blocks quantize their weights from the masters' float32
    values and pack the kernels' operands, baking in the per-site activation
    scales set by :func:`apply_act_scales`. A module prepares after the
    modules inside it (K12's pack shares its ``QuantLinear`` codes).

    ``absorbed_attention`` is the counterpart of
    ``prequantize_conv_tree(absorbed_attention=True)`` (:192-222): the int8
    absorbed attentions (K17) then read their calibrated ``to_q`` site, as
    ``CrossAttention._absorbed`` reads ``x_scale`` from prequantized leaves
    (:187-200). Without it they keep their static scale, as the in-graph
    branch does (:201-208), whatever the site says; the JAX trainer
    prequantizes with ``absorbed_attention=fused_norms``, so its unfused
    int8 UNet never reads the site."""
    from ..parallel.tp import whole_layer
    for m in int8_unet.modules():
        if hasattr(m, "absorbed_storage"):
            m.absorbed_storage = absorbed_attention
    src = dict(masters.named_parameters())
    for name, p in int8_unet.named_parameters():
        value = src[name]
        if value.shape != p.shape:
            # whole here, cut in the masters (K11 on heads that a model
            # axis does not divide): the shards gathered
            module, _, field = name.rpartition(".")
            value = getattr(whole_layer(masters.get_submodule(module)),
                            field)
        p.copy_(value)
    for name, m in reversed(list(int8_unet.named_modules())):
        if callable(getattr(m, "prepare", None)):
            m.prepare(masters.get_submodule(name))


@torch.no_grad()
def prepare_int8_vae(vae: nn.Module) -> nn.Module:
    """Fill the int8 codes of an image VAE or seg VAE built with
    ``use_int8`` from its own float weights, once: the resnet
    ``conv1``/``conv2`` and the image VAE's ``downsample``, and the seg
    decoder's ``in_conv``, ``out_conv`` and ``up{i}_convt``, the sites of
    the VAE half of ``prequantize_conv_tree`` (:132-241). The convs' codes
    are that function's (one scale per output channel, as ``QuantConv``
    also quantizes a float kernel); the upscalers' are those ``int8_dot``
    makes of a float kernel (one scale per (tap, channel) column), since
    the JAX trainer prequantizes no VAE. The weights are read as the module
    holds them (the trainer's compute-dtype cast, as the JAX trainer and
    bench quantize their cast trees); run it again whenever they change.
    Returns ``vae``."""
    for m in vae.modules():
        if isinstance(m, QuantConv2d) or (
                getattr(m, "use_int8", False) is True
                and callable(getattr(m, "prepare", None))):
            m.prepare(m)
    return vae


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def _sites(unet: nn.Module):
    """(site key, module whose output sets it, percentile allowed, model
    group or None) for each int8 activation site of a float UNet: resnet
    ``norm1``/``norm2`` outputs key ``conv1``/``conv2``; a transformer
    block's ``norm1`` keys ``attn1.to_q``, its ``norm3`` keys
    ``ff.net.0.proj``, its gated interior (the GEGLU output) keys
    ``ff.net.2`` (:599-625). Under tensor parallelism the norms' outputs are
    whole on every rank; the gated interior holds a rank's columns, and
    its amax is the maximum over the model group (the FF's ``tp_group``,
    set where ``apply_tp`` cut its columns)."""
    from ..models.layers import ResnetBlock
    from ..models.unet import BasicTransformerBlock
    for name, m in unet.named_modules():
        if isinstance(m, ResnetBlock):
            yield f"{name}.conv1", m.norm1, True, None
            yield f"{name}.conv2", m.norm2, True, None
        elif isinstance(m, BasicTransformerBlock):
            yield f"{name}.attn1.to_q", m.norm1, True, None
            yield f"{name}.ff.net.0.proj", m.norm3, True, None
            yield f"{name}.ff.net.2", m.ff.net[0], False, m.ff.tp_group


@torch.no_grad()
def calibrate_act_scale_tree(unet: nn.Module, sample: torch.Tensor,
                             timesteps, percentile: Optional[float] = None
                             ) -> Dict[str, float]:
    """Per-site static activation scales from one forward of the float
    ``unet``: ``max(amax, 1e-6) / 127`` of each site's input (or its
    ``percentile`` of |x|, except for the gated interior), keyed by the
    int8 module that reads it. Forward hooks take the values; the
    percentile runs on a numpy copy, since ``torch.quantile`` has an input
    size limit."""
    scales: Dict[str, float] = {}

    def record(key, use_percentile, group):
        def hook(_module, _inputs, out):
            if percentile is not None and use_percentile:
                a = np.abs(out.detach().float().cpu().numpy()).ravel()
                amax = np.percentile(a, percentile)
            else:
                amax = out.detach().float().abs().amax()
                if group is not None:
                    amax = group.max(amax)
                amax = np.float32(amax.item())
            scales[key] = max(scales.get(key, 0.0),
                              float(max(amax, 1e-6) / 127.0))
        return hook

    handles = [m.register_forward_hook(record(key, pct, group))
               for key, m, pct, group in _sites(unet)]
    try:
        unet(sample, timesteps)
    finally:
        for h in handles:
            h.remove()
    if not scales:
        raise ValueError("no resnet or transformer sites in this UNet")
    return scales


def act_scale_sites(int8_unet: nn.Module) -> Dict[str, Tuple[nn.Module,
                                                             Optional[str]]]:
    """Site key -> (int8 module, attribute) of an int8 UNet. An attribute
    of None marks a key the module takes and ignores (the ``to_q`` of K13
    and K15, whose projections stay float)."""
    sites = {}
    for name, m in int8_unet.named_modules():
        if isinstance(m, (QuantConv2d, QuantLinear)):
            sites[name] = (m, "x_scale")
        for key, attr in getattr(m, "act_scale_sites", {}).items():
            sites[f"{name}.{key}"] = (m, attr)
    return sites


def apply_act_scales(int8_unet: nn.Module,
                     scales: Optional[Dict[str, float]]) -> None:
    """Set every site's calibrated scale from ``scales`` (None clears them
    all, back to the module defaults). A key that names no site raises; a
    site whose attribute is None takes its key and ignores it.
    :func:`prepare_int8_unet` bakes them into the packed operands."""
    sites = act_scale_sites(int8_unet)
    scales = scales or {}
    unknown = sorted(set(scales) - set(sites))
    if unknown:
        raise KeyError(f"apply_act_scales: no int8 site {unknown[:3]}")
    for key, (m, attr) in sites.items():
        if attr is None:
            continue
        value = scales.get(key)
        setattr(m, attr, None if value is None else f32(value))
