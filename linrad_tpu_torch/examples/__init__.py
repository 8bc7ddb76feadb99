"""Twins of the JAX package's examples (examples/demo_rx.py,
demo_multirx.py, demo_tx.py, serve_rx.py) on this package alone.  Each
runs on the card unless given ``--device cpu``, and takes ``--tiny`` for a
cut geometry (the tests' size):

    python -m linrad_tpu_torch.examples.demo_rx [out_dir] [--device cpu]
"""
