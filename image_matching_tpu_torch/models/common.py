"""Shared building blocks — the counterpart of
`image_matching_tpu/models/common.py`.

Parameters live in f32; convolutions and matmuls run in the compute
dtype given at call time; normalisation is computed in f32 and cast
back, as JAX's dtype promotion does in the reference. Module attribute
names follow the JAX package's (`Conv_0`, `BatchNorm_0`, `Dense_0`,
`MaskedBatchNorm1d_0`, ...) so weights map across by path
(`image_matching_tpu_torch/weights.py`). `S2DConvBNReLU` /
`S2DDoubleConv` (2x2) and `S2DConvBNReLUH` / `S2DDoubleConvH` (H-only)
are the plain blocks with a second way to run, in a space-to-depth
layout on NHWC maps (`ops/s2d_conv.py`), on the same parameters. Both batch
norms have their training branches: `MaskedBatchNorm1d`'s for SuperGlue,
`BatchNorm`'s (flax `nn.BatchNorm` in training) for SuperPoint's plain
blocks. The s2d blocks stay inference-only, as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_h, fold_bn
from image_matching_tpu_torch.ops.s2d_conv import conv3x3_s2d_raw, conv3x3_s2dh_entry, conv3x3_s2dh_raw
from image_matching_tpu_torch.ops.s2d_entry import s2d_entry_conv
from image_matching_tpu_torch.parallel.collectives import from_model_axis, to_model_axis
from image_matching_tpu_torch.parallel.mesh import all_sum, current_mesh

EPS = 1e-5


class BatchNorm(nn.Module):
    """Batch norm over the channel axis `dim`, flax `nn.BatchNorm`
    (momentum 0.9): (x - mean) * (rsqrt(var + eps) * scale) + bias in f32,
    cast back to x's dtype. Inference uses the running statistics; it is
    also the inference branch of `MaskedBatchNorm1d` (which ignores the
    mask there). Training (`train=True`) uses the batch's statistics over
    every axis but the channel's, in f32, with flax's fast variance
    E[x^2] - E[x]^2 clipped at 0 (the biased variance), and moves the
    running statistics ra = 0.9 * ra + 0.1 * batch in place, without grad.
    Under a data mesh (`parallel.use_mesh`) the statistics are the global
    batch's: every rank holds a shard of the same size, so the ranks' means
    of x and x^2 are averaged (one all_reduce), and every rank normalises
    and tracks alike."""

    MOMENTUM = 0.9

    def __init__(self, features: int, dim: int = -1):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, dim=None, train: bool = False):
        """`dim` overrides the channel axis for this call (the s2d path
        normalises NHWC views of maps whose modules are built for NCHW)."""
        axis = (self.dim if dim is None else dim) % x.dim()
        shape = [1] * x.dim()
        shape[axis] = -1
        xf = x.float()
        if train:
            axes = tuple(a for a in range(x.dim()) if a != axis)
            mean, sq = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            mesh = current_mesh()
            if mesh is not None:  # the global batch's means
                mean, sq = (all_sum(torch.stack([mean, sq])) / mesh.size).unbind(0)
            var = (sq - mean * mean).clamp_min(0.0)
            self.track(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = self.weight * torch.rsqrt(var + EPS)
        y = (xf - mean.reshape(shape)) * inv.reshape(shape)
        return (y + self.bias.reshape(shape)).to(x.dtype)

    @torch.no_grad()
    def track(self, mean, var) -> None:
        """Move the running statistics towards a batch's, flax's way."""
        mom = self.MOMENTUM
        self.running_mean.copy_(mom * self.running_mean + (1 - mom) * mean)
        self.running_var.copy_(mom * self.running_var + (1 - mom) * var)


class MaskedBatchNorm1d(BatchNorm):
    """Batch norm over (B, N, C) sequence features with a validity mask,
    the JAX package's `MaskedBatchNorm1d`. Inference uses the running
    statistics and ignores the mask. Training normalises with the mean and
    the biased variance over the valid (b, n) positions, in f32, and
    updates the running statistics with flax's convention,
    ra = 0.9 * ra + 0.1 * batch (in place, without grad). Under a data
    mesh the count and the sum are summed over the ranks in one all_reduce,
    then the squared deviations in a second."""

    def forward(self, x, mask=None, train: bool = False):
        if not train:
            return super().forward(x)
        xf = x.float()
        if mask is None and current_mesh() is None:
            mean = xf.mean(dim=(0, 1))
            var = xf.var(dim=(0, 1), unbiased=False)
        else:  # under a mesh, every sum is the global batch's
            w = mask.float()[..., None] if mask is not None else torch.ones_like(xf[..., :1])
            count, total = w.sum(), (xf * w).sum(dim=(0, 1))
            if current_mesh() is not None:  # the global batch's, in one all_reduce
                sums = all_sum(torch.cat([count[None], total]))
                count, total = sums[0].detach(), sums[1:]
            denom = count.clamp_min(1.0)
            mean = total / denom
            var = all_sum((w * (xf - mean) ** 2).sum(dim=(0, 1))) / denom
        self.track(mean, var)
        y = (xf - mean) * torch.rsqrt(var + EPS) * self.weight + self.bias
        return y.to(x.dtype)


class ConvBNReLU(nn.Module):
    """SAME conv -> BN -> ReLU on NCHW (channels_last) maps. In training the
    conv's output goes to BN in f32 and the ReLU's comes back in the
    compute dtype, as JAX's `bn_dtype` does."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, padding=kernel // 2)
        self.BatchNorm_0 = BatchNorm(features, dim=1)

    def forward(self, x, dtype, train: bool = False):
        if train:
            return torch.relu(self.BatchNorm_0(conv2d(x, self.Conv_0, dtype).float(), train=True)).to(dtype)
        return torch.relu(self.BatchNorm_0(conv2d(x, self.Conv_0, dtype)))

    def entry(self, image, h_layout: bool = False):
        """The same layer on a (B, H, W) image in the compute dtype, as one
        fused pass (`ops/entry_conv.py`: the CUDA kernel on the card);
        `h_layout` gives the H-only space-to-depth output."""
        bn = self.BatchNorm_0
        scale, shift = fold_bn(self.Conv_0.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var, EPS)
        fused = entry_conv_h if h_layout else entry_conv
        return fused(image, self.Conv_0.weight.permute(2, 3, 1, 0), scale, shift)


class DoubleConv(nn.Module):
    """(conv => BN => ReLU) * 2. A 3-dim input is the 1-channel image: in
    inference the first layer then runs as the fused entry conv (which has
    no backward), in training as a library conv of the (B, 1, H, W) image."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(in_channels, features)
        self.ConvBNReLU_1 = ConvBNReLU(features, features)

    def forward(self, x, dtype, train: bool = False):
        if x.dim() == 3 and not train:
            x = self.ConvBNReLU_0.entry(x)
        else:
            x = self.ConvBNReLU_0(x[:, None] if x.dim() == 3 else x, dtype, train)
        return self.ConvBNReLU_1(x, dtype, train)


def fold_parity(x, groups: int = 4):
    """View an s2d / U tensor (..., W', G*C) as (..., W'*G, C), so that
    per-channel ops (batch norm) see C features. G = 4 for the 2x2 layout,
    2 for the H-only layout."""
    *lead, wh, cg = x.shape
    return x.reshape(*lead, wh * groups, cg // groups)


def unfold_parity(x, cg: int, groups: int = 4):
    *lead, wg, _ = x.shape
    return x.reshape(*lead, wg // groups, cg)


def s2d_bias_bn(y, bias, bn: BatchNorm, dtype, groups: int = 4):
    """What follows a conv in an s2d layout, on an NHWC aligned or U
    tensor (..., G*C): the bias, tiled over the G parity groups and added
    in the compute dtype to the conv's rounded output, then the inference
    batch norm per channel."""
    y = y + bias.to(dtype).repeat(groups)
    return unfold_parity(bn(fold_parity(y, groups), dim=-1), y.shape[-1], groups)


class S2DConvBNReLU(ConvBNReLU):
    """`ConvBNReLU` that can also run in the 2x2 s2d layout (`s2d`), on
    NHWC maps, with the same parameters under the same names (`Conv_0`,
    `BatchNorm_0`): a state_dict loads into either class. `mode` selects the
    s2d conv: "entry" takes a direct map through
    `ops/s2d_entry.s2d_entry_conv` (the CUDA kernel on the card) and gives
    aligned s2d; "raw" takes aligned s2d and gives the unaligned U, whose
    realignment is left to the consumer. Inference only (running
    statistics). `forward` stays the plain layer, for inputs the s2d path
    does not take."""

    def __init__(self, in_channels: int, features: int, mode: str):
        super().__init__(in_channels, features)
        if mode not in ("entry", "raw"):
            raise ValueError(f"S2DConvBNReLU: mode {mode!r} not in ('entry', 'raw')")
        self.mode = mode

    def s2d(self, x, dtype):
        kernel = self.Conv_0.weight.permute(2, 3, 1, 0).to(dtype)  # (3, 3, ci, co)
        x = x.to(dtype)
        if self.mode == "entry":
            y = s2d_entry_conv(x.contiguous(), kernel)
        else:
            y = conv3x3_s2d_raw(x, kernel)
        return torch.relu(s2d_bias_bn(y, self.Conv_0.bias, self.BatchNorm_0, dtype))


class S2DDoubleConv(DoubleConv):
    """`DoubleConv` that can also run in the 2x2 s2d layout (`s2d`): entry
    conv, then raw conv. Direct NHWC map in, U out (a pool or a realign
    follows). The JAX package's `extra_cols` (a U widened to the 8-aligned
    width its TPU pool wants) is left to `ops/s2d_conv.conv3x3_s2d_raw`: the
    CUDA pool takes any width."""

    block = S2DConvBNReLU

    def __init__(self, in_channels: int, features: int):
        nn.Module.__init__(self)
        self.ConvBNReLU_0 = self.block(in_channels, features, "entry")
        self.ConvBNReLU_1 = self.block(features, features, "raw")

    def s2d(self, x, dtype):
        return self.ConvBNReLU_1.s2d(self.ConvBNReLU_0.s2d(x, dtype), dtype)


class S2DConvBNReLUH(S2DConvBNReLU):
    """`ConvBNReLU` that can also run in the H-only (2, 1) s2d layout
    (`s2d`), the JAX package's `S2DConvBNReLUH`, with the same parameters
    under the same names. "entry" takes a direct NHWC map through the
    stride-(2, 1) conv and gives alignedH; the image (ci = 1) goes through
    the fused entry conv's alignedH output (`ops/entry_conv.entry_conv_h`,
    conv bias and batch norm folded; the CUDA kernel on the card) in every
    compute dtype. "raw" takes alignedH and gives the unaligned Uh, whose
    row realignment is left to the consumer. Inference only, as in JAX:
    `train=True` raises."""

    def s2d(self, x, dtype, train: bool = False):
        if train:
            raise ValueError("S2DConvBNReLUH is inference-only (running BN stats); use ConvBNReLU for training")
        if self.mode == "entry" and x.shape[-1] == 1:
            return self.entry(x[..., 0].to(dtype).contiguous(), h_layout=True)
        kernel = self.Conv_0.weight.permute(2, 3, 1, 0).to(dtype)  # (3, 3, ci, co)
        conv = conv3x3_s2dh_entry if self.mode == "entry" else conv3x3_s2dh_raw
        y = conv(x.to(dtype), kernel)
        return torch.relu(s2d_bias_bn(y, self.Conv_0.bias, self.BatchNorm_0, dtype, groups=2))


class S2DDoubleConvH(S2DDoubleConv):
    """`S2DDoubleConv` in the H-only layout: direct NHWC map in, Uh out."""

    block = S2DConvBNReLUH


def max_pool_stride2(x):
    return F.max_pool2d(x, 2, 2)


def conv2d(x, conv: nn.Conv2d, dtype):
    """flax `nn.Conv` numerics: conv and bias add in the compute dtype, the
    conv's output rounded before the bias is added, as flax does. (Given
    the bias, `F.conv2d` on the CPU adds it before that rounding.)"""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding=conv.padding)
    return y.add_(conv.bias.to(dtype)[:, None, None])


def dense(x, linear: nn.Linear, dtype):
    """flax `nn.Dense` numerics: matmul and bias add in the compute dtype."""
    return x.to(dtype) @ linear.weight.t().to(dtype) + linear.bias.to(dtype)


def split_dense(x, x2, linear: nn.Linear, x2_fold, dtype):
    """`dense` over an implicit concat([x, x2], -1) without forming it
    (the JAX package's `_SplitDense`). With `x2_fold` (its inference
    form), x2 stands for x2 @ Wf + bf, and that projection is folded into
    the x2 half of the kernel, in f32, once per call; without it (the
    training form), y = x @ K[:c1] + x2 @ K[c1:] + b."""
    c1 = x.shape[-1]
    kernel = linear.weight.t()  # (c1 + c2, out), f32
    if x2_fold is None:
        k = kernel.to(dtype)
        return x.to(dtype) @ k[:c1] + x2.to(dtype) @ k[c1:] + linear.bias.to(dtype)
    k2 = (x2_fold.weight.t().float() @ kernel[c1:]).to(dtype)
    bias = linear.bias + x2_fold.bias.float() @ kernel[c1:]
    y = x.to(dtype) @ kernel[:c1].to(dtype) + x2.to(dtype) @ k2
    return y + bias.to(dtype)


class SeqMLP(nn.Module):
    """1x1-conv MLP over (B, N, C): Dense + (BN + ReLU) between layers,
    plain Dense at the end. `channels` includes the input width. `tp`: the
    model axis when `parallel/sharding.apply_param_sharding` has split a
    two-layer MLP over it (None unsharded): `Dense_0` column-parallel, its
    batch norm on this rank's channels, `Dense_1` row-parallel."""

    tp = None

    def __init__(self, channels):
        super().__init__()
        self.n = len(channels) - 1
        for i in range(self.n):
            setattr(self, f"Dense_{i}", nn.Linear(channels[i], channels[i + 1]))
            if i < self.n - 1:
                setattr(self, f"MaskedBatchNorm1d_{i}", MaskedBatchNorm1d(channels[i + 1]))

    def forward(self, x, dtype, x2=None, x2_fold=None, mask=None, train: bool = False):
        """`x2`, `x2_fold`: a second input that the first layer takes as if
        concatenated onto x, after the projection `x2_fold` if one is given
        (`split_dense`). `mask`, `train`: the batch norms' (B, N) validity
        mask and training switch."""
        tp = self.tp
        if tp is not None:  # the column-parallel layer's inputs
            x = to_model_axis(x, tp)
            x2 = None if x2 is None else to_model_axis(x2, tp)
        for i in range(self.n):
            lin = getattr(self, f"Dense_{i}")
            if i == 0 and x2 is not None:
                x = split_dense(x, x2, lin, x2_fold, dtype)
            elif tp is not None and i == self.n - 1:  # row-parallel: the ranks' partial products summed
                x = from_model_axis(x.to(dtype) @ lin.weight.t().to(dtype), tp) + lin.bias.to(dtype)
            else:
                x = dense(x, lin, dtype)
            if i < self.n - 1:
                x = torch.relu(getattr(self, f"MaskedBatchNorm1d_{i}")(x, mask, train))
        return x


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded initialisation matching the JAX package's initialisers in
    kind: LeCun-normal conv/dense kernels (untruncated), zero biases, unit
    norm scales, zero mean / unit variance statistics, dustbin score 1."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    for name, p in module.named_parameters():
        if name.endswith("bin_score"):
            p.fill_(1.0)
