"""The benchmark of ``repro_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
from the root of a checkout runs one cell of ``BENCHMARK.json`` and prints
one JSON line. What belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own that the harness finds by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``mode`` names the driver under
``modes/``), ``metrics/<metric>.py`` and ``limits/<workload>.json``.

Nothing here imports ``jax``, ``flax`` or the JAX package ``repro``; the
plain fp32 reference under ``reference/`` imports nothing of
``repro_torch`` either.
"""
