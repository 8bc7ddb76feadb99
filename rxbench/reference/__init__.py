"""The plain reference that decides ``correct``.

A frozen copy of ``linrad_tpu_torch``'s eager receive chain (``params``,
``geometry``, ``ops``, ``weak.{afc,pol,spur}``, ``utils``,
``pipeline.{chain,control}``) in plain PyTorch and numpy, with the plain
versions of the port's three hand kernels in place of the kernels
(``ops/fused_fft1.py``: torch.fft; ``ops/blanker.py:blanker_fits`` and
``ops/sellim.py:sellim_taper``: their loops of small tensor operations).
Its imports are relative: it imports nothing of ``linrad_tpu_torch`` and
nothing of JAX, and builds its own parameters, geometry, tables and state
from a configuration's fields.  :mod:`.receiver` holds the host loop of a
receiver and of a fleet, copied from the port's ``Receiver`` and
``FleetRunner``.
"""
