"""Signal-chain stages of the port, one module per linrad_tpu.ops module."""
