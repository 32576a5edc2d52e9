"""The benchmark of the PyTorch and CUDA port (``repro_torch``): sealed
continuous serving, driven by the data files beside this package."""
