"""Training systems of the port (JAX counterpart: ``dge_tpu/systems``)."""
