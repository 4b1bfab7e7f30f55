"""MobileViT (v1) video classifier, channels-last.

Counterpart of ``picklebot_tpu/models/mobilevit.py`` (plain forward), with
the reference's module tree, so its state dict has the reference keys:
conv1 = conv_nxn_bn(3, ch[0], stride 2); stem = 4 Bottleneck3D; trunk = 3
stages of Sequential(Bottleneck3D stride 2, MobileViTBlock); to_logits =
(conv_1x1_bn, global average pool, bias-free Linear). Each MobileViTBlock
pads (T, H, W) to multiples of the (2, 2, 2) patch, regroups the tokens
into 8 patch-position sequences of t*h*w tokens (a reshape and permute),
runs a pre-LN transformer (8 heads of 16), folds back, crops, concatenates
the block input and fuses with conv4.

The reference's quirks are kept: conv_nxn_bn pads by 1 whatever its
kernel size, its BatchNorm has no affine terms, the FeedForward has no
pre-norm, trunk[1]'s expansion is ``ch[7] * expansion`` and trunk[2]'s a
literal ``* 4``. Parameters: xxs 2,030,368 / xs 3,483,984 / s 8,453,136.

Input (B, T, H, W, 3) in the compute dtype; output (B, num_classes) logits
in the same dtype. Every conv and linear weight is drawn from N(0, 0.02^2)
with a ``torch.Generator`` seed and every bias is zero, as the reference
initializes; BatchNorm starts at identity statistics. The bottlenecks run
the fused kernels of ``ops/fused_bottleneck.py`` on the card, the
attention the flash kernels of ``ops/flash_attention.py`` and each block's
dense stride-1 3x3x3 ``conv1``/``conv4`` the conv kernel of
``ops/folded_conv.py``; the stride-2 stem conv, the 1x1 convs and the
linears are cuDNN and matmul calls, as the JAX package leaves them to XLA.

The parallel layouts of the JAX model, each over an axis of
``parallel/mesh.py``'s mesh: ``model_axis`` shards every FeedForward's
hidden width over that axis (tensor parallelism, Megatron's f and g of
``parallel/megatron.py``; the rank holds its 1/size of ``net.0`` and
``net.3``, which ``reset_parameters`` draws whole and slices, so the
seeded weights are the one-process model's), and ``sequence_axis``
shards every transformer stack's tokens (sequence parallelism,
``parallel/sequence.py`` and ring attention). The two axes must differ.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.attention import MultiHeadAttention
from picklebot_tpu_torch.ops.bottleneck import Bottleneck3D
from picklebot_tpu_torch.ops.conv import Conv3d
from picklebot_tpu_torch.ops.linear import (Dropout, GlobalAvgPool, Linear,
                                            current_dropout_rng,
                                            keyed_seed_stream, keyed_stream)
from picklebot_tpu_torch.ops.moe import MoEFeedForward
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.parallel.megatron import (shard_tensor, tp_copy_in,
                                                   tp_reduce_out)

_INIT_STD = 0.02


class ConvBNSiLU(nn.Sequential):
    """(Conv3d, BatchNorm without affine terms, SiLU) under the
    reference's Sequential keys ``0.weight`` and ``1.running_*``, with a
    forward that hands ``kernels`` on to the conv."""

    def __init__(self, cin, cout, kernel_size, stride, padding):
        super().__init__(
            Conv3d(cin, cout, kernel_size, stride=stride, padding=padding,
                   bias=False),
            BatchNorm(cout, affine=False), act.Activation(act.silu))

    def forward(self, x, kernels: bool = True):
        return self[2](self[1](self[0](x, kernels=kernels)))


def conv_1x1_bn(cin, cout):
    return ConvBNSiLU(cin, cout, 1, 1, 0)


def conv_nxn_bn(cin, cout, kernel_size=3, stride=1):
    return ConvBNSiLU(cin, cout, kernel_size, stride, 1)


class FeedForward(nn.Module):
    """Linear -> SiLU -> Dropout -> Linear -> Dropout, bias-free, with no
    pre-norm (the reference's).

    With ``model_axis`` (an axis of more than one rank) the hidden width is
    sharded over it: the rank holds rows ``net.0`` and columns ``net.3``
    of its 1/size (``sharded``), the input enters through
    ``tp_copy_in`` and the partial outputs sum through ``tp_reduce_out``
    before the last dropout, as the JAX ``FeedForward`` does."""

    def __init__(self, embed_dim, hidden_dim, dropout=0.0, model_axis=None):
        super().__init__()
        n = mesh.axis_size(model_axis) if model_axis else 1
        if hidden_dim % n:
            raise ValueError(f"FeedForward hidden width {hidden_dim} does "
                             f"not split over {n} model-parallel ranks")
        self.model_axis = model_axis if n > 1 else None
        self.net = nn.Sequential(
            Linear(embed_dim, hidden_dim // n, bias=False),
            act.Activation(act.silu), Dropout(dropout),
            Linear(hidden_dim // n, embed_dim, bias=False), Dropout(dropout))
        self.sharded = {}
        if self.model_axis:
            self.sharded = {"net.0.weight": ("model", 0),
                            "net.3.weight": ("model", 1)}
            r = mesh.axis_index(model_axis)
            # reset_parameters draws the whole weight and keeps the slice
            self.net[0].tp_full = ((hidden_dim, embed_dim), 0, r, n)
            self.net[3].tp_full = ((embed_dim, hidden_dim), 1, r, n)

    def forward(self, x):
        if self.model_axis is None:
            return self.net(x)
        x = tp_copy_in(x, self.model_axis)
        x = self.net[3](self.net[2](self.net[1](self.net[0](x))))
        return self.net[4](tp_reduce_out(x, self.model_axis))


class TransformerStack(nn.Module):
    """depth x (pre-LN attention + residual, FeedForward + residual).

    ``model_axis`` shards the FeedForwards (tensor parallelism).
    ``sequence_axis``: when the axis has more than one rank and divides
    the token count N, the tokens are scattered over it at entry
    (``sp_scatter_tokens``) and gathered at exit, attention is ring
    attention over the blocks, and LayerNorm, FFN, residuals and dropout
    run on the local block; ``sp_engaged`` records it, so that the train
    step sums exactly these parameters' gradients over the axis
    (``sequence.sp_sync_grads``). Otherwise the stack runs replicated
    (stage 2 of MobileViT-s, N = 147, at an even axis). Under dropout the
    token-sharded layers draw from a stream seeded with the axis rank
    (the JAX stack folds it into its key).

    ``pipeline_axis``: when the axis has more than one rank, divides the
    depth and ``pipeline_microbatches`` (default: the axis size) divides
    the batch, the layers run as a GPipe pipeline of axis-size stages
    (``parallel/pipeline.py``), after the token scatter under SP, with ring
    attention inside each tick; ``pp_engaged`` records it, so that the
    train step sums these parameters' gradients over the axis
    (``pipeline.pp_sync_grads``). Otherwise the plain loop runs (stage 3
    of MobileViT-s, depth 3, at an even axis). Under dropout each layer
    application draws from a stream keyed by (layer, microbatch), seeded
    from the current one.

    ``moe_experts`` > 0: each FeedForward is an ``MoEFeedForward`` under
    ``ffs.i`` (the JAX export's keys), the attention stays at
    ``layers.i.0``."""

    def __init__(self, embed_dim, depth, heads, dim_head, ffw_dim,
                 dropout=0.0, backend="auto", model_axis=None,
                 sequence_axis=None, pipeline_axis=None,
                 pipeline_microbatches=None, moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, expert_axis=None,
                 moe_dispatch="replicated"):
        super().__init__()
        if sequence_axis is not None and sequence_axis == model_axis:
            raise ValueError(
                "sequence_axis and model_axis must be distinct mesh axes: "
                "token-sharded FFN inputs with hidden-sharded weights would "
                "sum partials of different token blocks together")
        if pipeline_axis is not None and pipeline_axis in (model_axis,
                                                           sequence_axis):
            raise ValueError(
                "pipeline_axis must be distinct from model_axis and "
                "sequence_axis: a stage hop over a TP/SP axis would rotate "
                "activations between ranks holding different weight/token "
                "shards")
        if moe_experts and (model_axis or sequence_axis or pipeline_axis):
            raise ValueError(
                "moe_experts composes with DP and expert parallelism only: "
                "TP shards the dense FFN the MoE replaces, SP would change "
                "routing/capacity semantics per token shard, and PP's "
                "stages would each publish a part of the aux loss")
        self.sequence_axis = sequence_axis
        self.pipeline_axis = pipeline_axis
        self.pipeline_microbatches = pipeline_microbatches
        self.dropout = dropout
        self.sp_engaged = False
        self.pp_engaged = False

        def attention():
            return MultiHeadAttention(embed_dim, heads, dim_head, dropout,
                                      backend=backend,
                                      sequence_axis=sequence_axis)
        if moe_experts:
            self.layers = nn.ModuleList([nn.ModuleList([attention()])
                                         for _ in range(depth)])
            self.ffs = nn.ModuleList([
                MoEFeedForward(embed_dim, ffw_dim, moe_experts, moe_top_k,
                               moe_capacity_factor, dropout,
                               expert_axis=expert_axis,
                               dispatch=moe_dispatch)
                for _ in range(depth)])
        else:
            self.layers = nn.ModuleList([
                nn.ModuleList([attention(),
                               FeedForward(embed_dim, ffw_dim, dropout,
                                           model_axis=model_axis)])
                for _ in range(depth)])

    def pairs(self):
        """[(attention, feed-forward)] per layer."""
        if hasattr(self, "ffs"):
            return [(a[0], f) for a, f in zip(self.layers, self.ffs)]
        return [(a, f) for a, f in self.layers]

    def sp_active(self, n_tokens: int) -> bool:
        """Whether a sequence of ``n_tokens`` runs token-sharded."""
        if self.sequence_axis is None:
            return False
        size = mesh.axis_size(self.sequence_axis)
        return size > 1 and n_tokens % size == 0

    def microbatches(self) -> int:
        return (self.pipeline_microbatches
                or mesh.axis_size(self.pipeline_axis))

    def pp_active(self, batch: int) -> bool:
        """Whether a batch of ``batch`` runs as a pipeline."""
        if self.pipeline_axis is None:
            return False
        size = mesh.axis_size(self.pipeline_axis)
        return (size > 1 and len(self.layers) % size == 0
                and batch % self.microbatches() == 0)

    def forward(self, x, kernels: bool = True):
        sp = self.sp_active(x.shape[-2])
        pp = self.pp_active(x.shape[0])
        self.sp_engaged, self.pp_engaged = sp, pp
        if not sp and not pp:
            for attn, ff in self.pairs():
                x = attn(x, kernels=kernels) + x
                x = ff(x) + x
            return x
        from picklebot_tpu_torch.parallel.sequence import (sp_gather_tokens,
                                                           sp_scatter_tokens)
        with self._rank_stream() if sp else contextlib.nullcontext():
            if sp:
                x = sp_scatter_tokens(x, self.sequence_axis)
            if pp:
                x = self._pipelined(x, kernels, sp)
            else:
                for attn, ff in self.pairs():
                    x = attn(x, kernels=kernels, sp_active=True) + x
                    x = ff(x) + x
        if sp:
            x = sp_gather_tokens(x, self.sequence_axis)
        return x

    def _pipelined(self, x, kernels, sp):
        """The layers as a GPipe pipeline over the pipeline axis."""
        from picklebot_tpu_torch.parallel.pipeline import gpipe_apply
        g = current_dropout_rng()
        seed = None
        if self.training and self.dropout > 0 and g is not None:
            seed = int(torch.randint(2 ** 62, (1,), generator=g,
                                     device=g.device))

        def stream(*keys):
            if seed is None:
                return contextlib.nullcontext()
            return keyed_seed_stream(seed, *keys, device=g.device)

        def layer_fn(pair, layer, mb, h):
            attn, ff = pair
            with stream(layer, 2 * mb):
                h = attn(h, kernels=kernels, sp_active=sp) + h
            with stream(layer, 2 * mb + 1):
                h = ff(h) + h
            return h

        return gpipe_apply(layer_fn, self.pairs(), x, self.pipeline_axis,
                           self.microbatches())

    def _rank_stream(self):
        """Under train-mode dropout, a dropout generator seeded from the
        current one and this rank of the axis: independent masks per
        token block. Without dropout the current stream is left as it
        is."""
        g = current_dropout_rng()
        if not (self.training and self.dropout > 0) or g is None:
            return contextlib.nullcontext()
        return keyed_stream(g, mesh.axis_index(self.sequence_axis))


class MobileViTBlock(nn.Module):
    def __init__(self, embed_dim, depth, channel, kernel_size=3,
                 patch_size=(2, 2, 2), ffw_dim=None, dropout=0.0,
                 backend="auto", **layout):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.conv1 = conv_nxn_bn(channel, channel, kernel_size)
        self.conv2 = conv_1x1_bn(channel, embed_dim)
        self.transformer = TransformerStack(embed_dim, depth, 8, 16, ffw_dim,
                                            dropout, backend, **layout)
        self.conv3 = conv_1x1_bn(embed_dim, channel)
        self.conv4 = conv_nxn_bn(2 * channel, channel, kernel_size)

    def forward(self, x, kernels: bool = True):
        y = x
        x = self.conv2(self.conv1(x, kernels=kernels))
        b, t, h, w, d = x.shape
        pt, ph, pw = self.patch_size
        tp, hp, wp = -(-t // pt), -(-h // ph), -(-w // pw)
        x = F.pad(x, (0, 0, 0, wp * pw - w, 0, hp * ph - h, 0, tp * pt - t))
        # unfold: (B, T, H, W, D) -> (B, pt*ph*pw, t*h*w, D)
        x = x.reshape(b, tp, pt, hp, ph, wp, pw, d)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, pt * ph * pw,
                                                      tp * hp * wp, d)
        x = self.transformer(x, kernels=kernels)
        # fold back and crop the padding
        x = x.reshape(b, pt, ph, pw, tp, hp, wp, d)
        x = x.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, tp * pt, hp * ph,
                                                      wp * pw, d)
        x = self.conv3(x[:, :t, :h, :w, :])
        return self.conv4(torch.cat([x, y.to(x.dtype)], dim=-1),
                          kernels=kernels)


class MobileViT(nn.Module):
    def __init__(self, dims: Sequence[int], channels: Sequence[int],
                 num_classes: int, expansion: int = 4,
                 kernel_size: int = 3,
                 patch_size: Tuple[int, int, int] = (2, 2, 2),
                 depths: Tuple[int, int, int] = (2, 4, 3),
                 attention_backend: str = "auto", seed: int = 0,
                 model_axis=None, sequence_axis=None, pipeline_axis=None,
                 pipeline_microbatches=None, moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, expert_axis=None,
                 moe_dispatch="replicated"):
        super().__init__()
        assert len(dims) == 3 and len(depths) == 3
        ch = list(channels)
        self.num_classes = num_classes
        B = Bottleneck3D
        self.conv1 = conv_nxn_bn(3, ch[0], stride=2)
        self.stem = nn.ModuleList([
            B(ch[0], ch[1], ch[0] * expansion, stride=1),
            B(ch[1], ch[2], ch[1] * expansion, stride=2),
            B(ch[2], ch[3], ch[2] * expansion, stride=1),
            B(ch[2], ch[3], ch[2] * expansion, stride=1),
        ])

        layout = dict(model_axis=model_axis, sequence_axis=sequence_axis,
                      pipeline_axis=pipeline_axis,
                      pipeline_microbatches=pipeline_microbatches,
                      moe_experts=moe_experts, moe_top_k=moe_top_k,
                      moe_capacity_factor=moe_capacity_factor,
                      expert_axis=expert_axis, moe_dispatch=moe_dispatch)

        def vit(i, ffw_mult, channel):
            return MobileViTBlock(dims[i], depths[i], channel, kernel_size,
                                  patch_size, int(dims[i] * ffw_mult),
                                  backend=attention_backend, **layout)

        self.trunk = nn.ModuleList([
            nn.Sequential(B(ch[3], ch[4], ch[3] * expansion, stride=2),
                          vit(0, 2, ch[5])),
            # reference quirk: the expansion comes from ch[7], the next
            # stage's width, not from this block's ch[5]
            nn.Sequential(B(ch[5], ch[6], ch[7] * expansion, stride=2),
                          vit(1, 4, ch[7])),
            # reference quirk: a literal 4, not the expansion
            nn.Sequential(B(ch[7], ch[8], ch[7] * 4, stride=2),
                          vit(2, 4, ch[9])),
        ])
        self.to_logits = nn.Sequential(
            conv_1x1_bn(ch[-2], ch[-1]), GlobalAvgPool(),
            Linear(ch[-1], num_classes, bias=False))
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv3d, Linear)):
                with torch.no_grad():
                    full = getattr(m, "tp_full", None)
                    if full is None:
                        m.weight.normal_(0.0, _INIT_STD, generator=g)
                    else:   # the whole weight drawn, this rank's slice kept
                        shape, dim, r, n = full
                        w = torch.empty(shape).normal_(0.0, _INIT_STD,
                                                       generator=g)
                        m.weight.copy_(shard_tensor(w, dim, r, n))
                    if m.bias is not None:
                        m.bias.zero_()
            elif m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    def bottlenecks(self):
        yield from self.stem
        for stage in self.trunk:
            yield stage[0]

    def forward(self, x, kernels: bool = True):
        """``kernels=False`` runs the plain bottleneck chain, ``sdpa`` and
        ``F.conv3d`` even on the card (the reference the kernels are held
        against)."""
        x = self.conv1(x, kernels=kernels)
        for block in self.stem:
            x = block(x, kernels=kernels)
        for bottleneck, vit_block in self.trunk:
            x = vit_block(bottleneck(x, kernels=kernels), kernels=kernels)
        return self.to_logits(x)


# the reference's config/mobilevit_{xxs,xs,s}.json
MOBILEVIT_CONFIGS = {
    "xxs": dict(dims=[64, 80, 96],
                channels=[16, 16, 24, 24, 48, 48, 64, 64, 80, 80, 320]),
    "xs": dict(dims=[96, 120, 144],
               channels=[16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384]),
    "s": dict(dims=[144, 192, 240],
              channels=[16, 32, 64, 64, 96, 96, 128, 128, 160, 160, 640]),
}
