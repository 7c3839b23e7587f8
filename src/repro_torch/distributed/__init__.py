"""Accounting of the port's steps (``flops``): the counts the reference's
``repro/distributed/hlo.py`` reads from compiled HLO."""
