"""Neural models of the port (plain ``torch.nn`` modules, diffusers /
transformers / torchvision parameter names): the VGG16 / LPIPS perceptual
distance (lpips.py), the diffusion building blocks (layers.py), the SD-1.5
UNet (unet.py), the VAE (vae.py), the CLIP text encoder (clip_text.py) and
the CLIP vision tower with the edit-quality scorer (clip_vision.py).

JAX counterpart: ``dge_tpu/models/``."""
