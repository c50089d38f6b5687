"""parallel layer of the PyTorch/CUDA port (mirrors edl_tpu/parallel)."""
