"""The benchmark of the PyTorch and CUDA port (``femus_tpu_torch``); see
README.md."""
