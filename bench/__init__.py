"""The benchmark of ``repro_torch`` serving on one H100 (see README.md).

Importing this package imports nothing of the program: the harness modules
that drive ``repro_torch`` (``system`` and the architectures' bridges,
``bridges/<arch>.py``, which ``spec.resolve`` loads) are loaded by a run.
"""
