"""PyTorch port of disentangle_mlp_tpu for NVIDIA Hopper GPUs (see README)."""
