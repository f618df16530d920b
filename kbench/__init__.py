"""The benchmark of the PyTorch/CUDA port (``kmerseek_tpu_torch``); see README.md."""
