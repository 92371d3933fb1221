"""Drivers, one a kind of traffic; a traffic file's ``mode`` names one.

A driver is a module with a ``Driver(cell, seed, device)`` class offering
``setup()``, ``window(seconds)``, ``traced()``, ``release()`` and
``check(lowp=None)``; ``portbench/run.py`` calls them in that order.
"""
