from .losses import (bce, bce_logits, kld, reconstruction_loss, sim_loss,
                     vae_loss)

__all__ = ["bce", "bce_logits", "kld", "sim_loss", "reconstruction_loss",
           "vae_loss"]
