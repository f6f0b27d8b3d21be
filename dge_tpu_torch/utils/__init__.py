"""Config, saving (JAX counterpart: ``dge_tpu/utils/``)."""
