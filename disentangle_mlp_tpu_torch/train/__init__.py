from .common import Adam, model_state, load_model_state
from .vae import VAEExperiment
from .gan import GANExperiment
from .vaegan import VAEGANExperiment

__all__ = [
    "Adam",
    "model_state",
    "load_model_state",
    "VAEExperiment",
    "GANExperiment",
    "VAEGANExperiment",
]
