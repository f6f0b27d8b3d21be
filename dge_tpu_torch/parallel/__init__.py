"""Camera batching (mesh.py). The multi-GPU paths are still to port
(ROADMAP.md §1 item 5).

JAX counterpart: ``dge_tpu/parallel/``."""
