"""The receive chain (chain.py), the host-side AFC control (control.py) and
the Receiver (receiver.py)."""
