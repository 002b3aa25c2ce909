"""The benchmark of the PyTorch/CUDA port (`spgemm_tpu_torch`): see README.md."""
