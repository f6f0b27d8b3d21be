"""Rendering ops: SH, projection, pair binning, the pair-stream compositing
kernel and the render API (JAX counterpart: ``dge_tpu/ops/``)."""
