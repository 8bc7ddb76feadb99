"""The receive chain (chain.py) and the host-side Receiver (receiver.py)."""
