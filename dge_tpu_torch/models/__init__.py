"""Neural models of the port (plain ``torch.nn`` modules). So far the
VGG16 / LPIPS perceptual distance (lpips.py); the diffusion models follow.

JAX counterpart: ``dge_tpu/models/``."""
