"""Faults planted in the program's timed path, one a file: ``plant(mp)``
patches the port through ``mp`` (a ``pytest.MonkeyPatch``), which undoes
it. A traffic driver names the faults its cells can have in ``FAULTS``;
the CPU tests and ``tools/readings.py`` find each here by that name."""
