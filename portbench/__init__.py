"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its
harness (``run.py``), configurations, traffic, metric readers and the
frozen plain reference that decides ``correct``."""
