from .layers import Conv, ConvTranspose, Linear, BatchNorm
from .vae import CelebaEncoder, CelebaDecoder, VAE
from .gan import GeneratorCeleba, DiscriminatorCeleba

__all__ = [
    "Conv",
    "ConvTranspose",
    "Linear",
    "BatchNorm",
    "CelebaEncoder",
    "CelebaDecoder",
    "VAE",
    "GeneratorCeleba",
    "DiscriminatorCeleba",
]
