"""Command-line tools of the port (``python -m geneface_tpu_torch.tools.<name>``)."""
