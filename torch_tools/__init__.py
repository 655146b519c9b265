"""Tools of the PyTorch/CUDA port: each runs as ``python3
torch_tools/<name>.py`` and imports as ``torch_tools.<name>``."""
