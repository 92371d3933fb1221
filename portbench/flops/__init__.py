"""Operations and bytes of the port's work, worked out from shapes alone.

``peaks`` holds the card's published peaks, ``kernels`` each kernel's
operations and bytes (copies of ``chip_smoke.py``'s bounds), and
``model`` the launches a forward or a train step of a configuration makes,
with their shapes. Each input byte is read once and each output byte
written once; recomputation is not counted.
"""
