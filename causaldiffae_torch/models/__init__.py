"""UNet denoiser, attention, encoder, probe and SCM modules."""

from .attention import AttentionBlock, qkv_attention
from .encoder import GaussianConvEncoder, GaussianConvEncoderClf
from .layers import GroupNorm32, ResBlock, timestep_embedding
from .scm import CausalModeling
from .unet import CausalUNet

__all__ = ["AttentionBlock", "qkv_attention", "GaussianConvEncoder", "GaussianConvEncoderClf",
           "GroupNorm32",
           "ResBlock", "timestep_embedding", "CausalModeling", "CausalUNet"]
