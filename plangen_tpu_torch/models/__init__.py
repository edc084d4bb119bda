"""HF-named PyTorch modules of the layout-to-image slice."""
