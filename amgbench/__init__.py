"""The benchmark of pyamg_tpu_torch on an NVIDIA GPU (see README.md)."""
