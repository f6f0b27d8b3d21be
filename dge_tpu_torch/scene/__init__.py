"""Scene layer: PLY and COLMAP I/O, cameras, Gaussian buffers
(JAX counterpart: ``dge_tpu/scene/``)."""
