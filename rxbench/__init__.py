"""rxbench: the benchmark of linrad_tpu_torch, the PyTorch and CUDA port
of the linrad_tpu receiver, on one NVIDIA H100.  See README.md."""
