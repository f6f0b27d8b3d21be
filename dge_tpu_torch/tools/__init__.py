"""Command-line tools of the port: ``python -m dge_tpu_torch.tools.<name>``."""
