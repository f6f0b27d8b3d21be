"""Diffusion editing stack of the port: DDIM scheduler (ddim.py), epipolar
geometry (epipolar.py), the InstructPix2Pix pipeline (ip2p.py), the CLIP
tokenizer (tokenizer.py) and checkpoint loading (weights.py).

JAX counterpart: ``dge_tpu/diffusion/``."""
