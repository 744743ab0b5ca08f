"""The CausalDiffAE UNet denoiser.

Port of ``causaldiffae_tpu/models/unet.py:57-311``: ``denoise``, ``encode``,
``causalize``, ``encode_and_causalize``, the training forward (``forward``,
the counterpart of ``__call__``), ``feature_vectors`` and the
super-resolution variant ``SuperResUNet``. The module's mode stands for the
JAX package's ``train`` flag: ``model.train()`` normalises the encoder's
BatchNorm with the batch's statistics and updates the running ones
(``models/encoder.py``), and turns the ResBlocks' dropout on.

With ``flow_based`` the model holds the flow prior ``causal_flow`` and no
SCM ``causal_mask``; with ``causal_modeling`` too, the training forward
takes z_post from the flow and the representation KL's mask from the flow's
log-determinant. A flow model cannot be evaluated: ``causalize`` raises, as
the JAX package's ``encode_and_causalize`` does (``unet.py:228-242`` calls
the ``causal_mask`` that a flow model lacks).

Public methods take and return NHWC images, as the JAX package's do; the
blocks run NCHW inside. The module tree follows the reference torch
``state_dict`` keys (``time_embed``, ``label_emb``, ``input_blocks.{i}.{j}``,
``middle_block``, ``output_blocks``, ``out``, ``rep_emb``, ``up_emb``,
``causal_mask``, ``causal_flow``), so reference ``.pt`` files and flax
weights carried by ``utils/weights.py`` load with ``strict=True``.

Cast points kept from the JAX package: the embedding is computed in fp32
(time, label and ``up_emb`` denses) and then cast to the compute dtype; h is
cast back to the input dtype before the output GroupNorm; the output conv
runs in fp32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import sum_across_ranks
from ..parallel.grid import dp_group, dp_size
from ..utils import tracing
from .attention import AttentionBlock
from .encoder import GaussianConvEncoder
from .layers import Downsample, GroupNorm32, ResBlock, Upsample, conv, conv3x3, silu, timestep_embedding
from .scm import CausalModeling, MultivariateCausalFlow


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class CausalUNet(nn.Module):
    """UNet + causal representation conditioning."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Tuple[int, ...],
                 channel_mult: Tuple[int, ...] = (1, 2, 4, 8), image_size: int = 28,
                 num_classes: Optional[int] = None, c_dim: Optional[int] = None,
                 rep_dim: Optional[int] = None, causal_modeling: bool = False,
                 flow_based: bool = False, dropout: float = 0.0,
                 num_heads: int = 1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, n_vars: int = 4,
                 adjacency=None, learn_adjacency: bool = False, masking: bool = False,
                 drop_prob: float = 0.5, reparam_var_scale: float = 1e-3,
                 dtype: torch.dtype = torch.float32, use_kernels: bool = False,
                 use_remat: bool = False):
        super().__init__()
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.c_dim = c_dim
        self.rep_dim = rep_dim
        self.causal_modeling = causal_modeling
        self.flow_based = flow_based
        self.dropout = dropout
        self.masking = masking
        self.drop_prob = drop_prob
        self.reparam_var_scale = reparam_var_scale
        self.dtype = dtype
        self.use_remat = use_remat
        ted = model_channels * 4
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample

        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted), nn.SiLU(),
                                        nn.Linear(ted, ted))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)
        if c_dim is not None:
            self.c_emb = nn.Sequential(nn.Linear(c_dim, 256), nn.SiLU(), nn.Linear(256, ted))
        if rep_dim is not None:
            self.rep_emb = GaussianConvEncoder(in_channels, image_size, rep_dim,
                                               num_vars=n_vars, dtype=dtype)
            self.up_emb = nn.Linear(rep_dim, ted)
        if causal_modeling and not flow_based:
            self.causal_mask = CausalModeling(rep_dim, n_vars, adjacency, learn_adjacency)
        if flow_based:
            self.causal_flow = MultivariateCausalFlow(n_vars, rep_dim // n_vars)
            if causal_modeling:  # the flow's conditioning masks, C = I - A
                A = torch.tensor(adjacency, dtype=torch.float32)
                self.register_buffer("flow_C", torch.eye(n_vars) - A, persistent=False)

        def res(ch_in, ch_out):
            return ResBlock(ch_in, ted, ch_out, use_scale_shift_norm, dtype, dropout)

        def attn(ch, heads):
            return AttentionBlock(ch, heads, use_kernels, dtype)

        # Input (downsampling) stacks - reference `unet.py:388-433`.
        input_blocks = [nn.ModuleList([conv3x3(in_channels, model_channels)])]
        input_block_chans = [model_channels]
        ch = model_channels
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(attn(ch, num_heads))
                input_blocks.append(nn.ModuleList(layers))
                input_block_chans.append(ch)
            if level != len(channel_mult) - 1:
                input_blocks.append(nn.ModuleList([Downsample(ch, dtype)]))
                input_block_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(input_blocks)

        # Middle - reference `unet.py:438-456`.
        self.middle_block = nn.ModuleList([res(ch, None), attn(ch, num_heads), res(ch, None)])

        # Output (upsampling) stacks with skip concat - reference `unet.py:462-491`.
        output_blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + input_block_chans.pop(), model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, dtype))
                    ds //= 2
                output_blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(output_blocks)

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 conv3x3(model_channels, out_channels, zero_init=True))
        for m in self.modules():
            if isinstance(m, GroupNorm32):
                m.use_kernels = use_kernels

    # ------------------------------------------------------------------ #
    def _apply_seq(self, modules, h, emb, drop):
        """With ``use_remat`` and autograd recording, each ResBlock runs under
        ``torch.utils.checkpoint`` (non-reentrant), as ``nn.remat(ResBlock)``
        does: its activations are recomputed in the backward pass. Its
        dropout mask is drawn before, outside the recomputed region, so the
        recompute draws nothing and remat changes no value."""
        for m in modules:
            if isinstance(m, ResBlock):
                if self.use_remat and torch.is_grad_enabled():
                    h = checkpoint(m.block, h, emb, m.keep_mask(h, drop), use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    h = m(h, emb, drop)
            elif isinstance(m, nn.Conv2d):
                h = conv(m, h, self.dtype)
            else:
                h = m(h)
        return h

    def _embed(self, t, y, c, z):
        """Summed conditioning embedding, fp32 (reference `unet.py:545-617`)."""
        emb = self.time_embed[2](silu(self.time_embed[0](
            timestep_embedding(t, self.model_channels))))
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("must specify y iff the model is class-conditional")
        if self.num_classes is not None:
            emb = emb + self.label_emb(y)
        if self.c_dim is not None:
            emb = emb + self.c_emb[2](silu(self.c_emb[0](c.float())))
        if z is not None:
            emb = emb + self.up_emb(z.float())
        return emb

    # ------------------------------------------------------------------ #
    def denoise(self, x, t, y=None, c=None, z=None, *,
                drop: Optional[Callable[[torch.Size], torch.Tensor]] = None):
        """eps prediction given explicit conditioning; x and eps are NHWC.

        In train mode with dropout, ``drop(shape)`` gives each ResBlock's
        keep mask, in the order the blocks run (``layers.ResBlock``). Runs in
        the span ``cdae.unet.denoise`` and counts ``cdae.unet.calls``."""
        tracing.count("cdae.unet.calls")
        with tracing.span("cdae.unet.denoise"):
            emb = self._embed(t, y, c, z).to(self.dtype)
            h = _nchw(x).to(self.dtype)
            hs = []
            for blocks in self.input_blocks:
                h = self._apply_seq(blocks, h, emb, drop)
                hs.append(h)
            h = self._apply_seq(self.middle_block, h, emb, drop)
            for blocks in self.output_blocks:
                h = torch.cat([h, hs.pop()], dim=1)
                h = self._apply_seq(blocks, h, emb, drop)
            h = h.to(x.dtype)
            h = self.out[0](h, silu_after=True)
            return _nhwc(conv(self.out[2], h, torch.float32))

    def encode(self, x_start):
        """Semantic encoder q(u | x0) -> (mu, var); x_start is NHWC."""
        return self.rep_emb.encode(_nchw(x_start).to(self.dtype))

    def causalize(self, mu):
        """SCM pass u -> z_post (masking + per-var MLPs + add-back-noise)."""
        if self.flow_based:
            raise AttributeError("a flow-prior model (flow_based=True) has no SCM causal_mask "
                                 "to causalize with, so it cannot be evaluated; the JAX "
                                 "package's encode_and_causalize fails the same way")
        return self.causal_mask(mu)

    def encode_and_causalize(self, x_start, *, sample: bool = True,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None):
        """Encode, SCM, and draw z ~ N(z_post, reparam_var_scale).

        The reparameterization noise is ``noise`` when given, else drawn from
        ``generator``. With ``sample=False`` z is z_post.
        """
        mu, var = self.encode(x_start)
        z_post = self.causalize(mu) if self.causal_modeling else mu
        if not sample:
            return mu, var, z_post, z_post
        if noise is None:
            noise = torch.randn(z_post.shape, generator=generator, device=z_post.device,
                                dtype=z_post.dtype)
        v = torch.full_like(z_post, self.reparam_var_scale)
        return mu, var, z_post, z_post + torch.sqrt(v) * noise

    def flow_prior(self, mu):
        """(z_post, mask) of the flow prior: z_post = flow(mu, C) and the
        scalar mask -mean(log_det) of its reverse pass, the mean over the
        global batch under data parallelism (``parallel.sum_across_ranks``
        over the DP group, whose gradient reaches every rank's flow; the
        ranks' shares are equal)."""
        z_post, _ = self.causal_flow.flow(mu, self.flow_C)
        log_det, _ = self.causal_flow.reverse(z_post, self.flow_C)
        return z_post, -sum_across_ranks(log_det.sum(), dp_group()) / (len(log_det) * dp_size())

    def forward(self, x, t, y=None, c=None, x_start=None, z=None, *,
                rep_noise: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                drop: Optional[Callable[[torch.Size], torch.Tensor]] = None):
        """Training forward: returns ``(eps, aux)``, aux = {mu, var, z_post, mask}.

        With a representation and no ``z``: encode x_start, run the SCM (or
        the flow prior, whose scalar ``-mean(log_det)`` is then the mask), and
        draw z ~ N(z_post, var * reparam_var_scale) (the train-time variance
        is the encoder's, scaled). With ``masking`` a Bernoulli(1 - drop_prob)
        keep-mask per sample gates both z and z_post and is the mask.
        ``rep_noise`` (the reparameterization's standard normal draw, z_post's
        shape), ``keep`` ([B] of 0/1) and the dropout masks (``drop``, see
        :meth:`denoise`; each asked for at its block's full width, also under
        tensor parallelism) are used when given, else drawn from ``generator``.
        x, x_start and eps are NHWC.
        """
        aux = {}
        if drop is None:
            drop = lambda shape: torch.empty(  # noqa: E731
                shape, device=x.device).bernoulli_(1.0 - self.dropout, generator=generator)
        if self.rep_dim is not None and z is None:
            mu, var = self.encode(x_start)
            mask = None
            if self.causal_modeling and self.flow_based:
                z_post, mask = self.flow_prior(mu)
            else:
                z_post = self.causalize(mu) if self.causal_modeling else mu
            if rep_noise is None:
                rep_noise = torch.randn(z_post.shape, generator=generator,
                                        device=z_post.device, dtype=z_post.dtype)
            z = z_post + torch.sqrt(var * self.reparam_var_scale) * rep_noise
            if not self.causal_modeling:
                z_post = None
            if self.masking:
                if keep is None:
                    keep = torch.bernoulli(torch.full((z.shape[0],), 1.0 - self.drop_prob,
                                                      device=z.device), generator=generator)
                keep = keep.to(z.dtype)
                z = z * keep[:, None]
                if z_post is not None:
                    z_post = z_post * keep[:, None]
                mask = keep
            aux = {"mu": mu, "var": var, "z_post": z_post, "mask": mask}
        return self.denoise(x, t, y=y, c=c, z=z, drop=drop), aux

    def feature_vectors(self, x, t, y=None):
        """Every intermediate activation, NHWC in x's dtype: ``{"down": [...],
        "middle": ..., "up": [...]}`` (``unet.py:280-297``)."""
        emb = self._embed(t, y, None, None).to(self.dtype)
        h = _nchw(x).to(self.dtype)
        hs, result = [], {"down": [], "up": []}
        for blocks in self.input_blocks:
            h = self._apply_seq(blocks, h, emb, None)
            hs.append(h)
            result["down"].append(_nhwc(h).to(x.dtype))
        h = self._apply_seq(self.middle_block, h, emb, None)
        result["middle"] = _nhwc(h).to(x.dtype)
        for blocks in self.output_blocks:
            h = self._apply_seq(blocks, torch.cat([h, hs.pop()], dim=1), emb, None)
            result["up"].append(_nhwc(h).to(x.dtype))
        return result


class SuperResUNet(CausalUNet):
    """Super-resolution variant (``unet.py:300-311``): the UNet over x and the
    bilinear upsampling of ``low_res`` concatenated on channels. A subclass,
    as the reference's ``SuperResModel`` is of ``UNetModel``, so its
    ``state_dict`` keys have no prefix (flax's have ``unet``)."""

    def forward(self, x, t, low_res=None, **kwargs):
        """``(eps, aux)`` of :meth:`CausalUNet.forward` on ``[x, up(low_res)]``, NHWC.

        ``F.interpolate``'s bilinear with half-pixel centres is
        ``jax.image.resize``'s triangle kernel when it upsamples: an output
        pixel left of the first input centre takes the edge value in both
        (torch clamps the coordinate, jax renormalises the one weight left)."""
        up = F.interpolate(_nchw(low_res), size=x.shape[1:3], mode="bilinear",
                           align_corners=False)
        return super().forward(torch.cat([x, _nhwc(up)], dim=-1), t, **kwargs)
