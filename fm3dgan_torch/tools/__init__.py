"""Command-line entry points of the port (``python -m fm3dgan_torch.tools.<name>``)."""
