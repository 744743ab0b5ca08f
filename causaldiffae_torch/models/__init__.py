"""UNet denoiser, attention, encoder and SCM modules (serving subset)."""

from .attention import AttentionBlock, qkv_attention
from .encoder import GaussianConvEncoder
from .layers import GroupNorm32, ResBlock, timestep_embedding
from .scm import CausalModeling
from .unet import CausalUNet

__all__ = ["AttentionBlock", "qkv_attention", "GaussianConvEncoder", "GroupNorm32",
           "ResBlock", "timestep_embedding", "CausalModeling", "CausalUNet"]
