"""Command-line entry points of the port (``python -m puppax_torch.scripts.<name>``)."""
