"""Command-line entry points of the port (``python -m
incomplete_multimodal_fusion_tpu_torch.cli.<name>``)."""
