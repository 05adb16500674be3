"""The benchmark of ``repro_torch`` serving on one H100 (see README.md).

Importing this package imports nothing of the program: the harness modules
that drive ``repro_torch`` (``system``) are imported by ``run.py`` only.
"""
