"""Plain references, one a public entry of the port (``<entry>.py``),
each over the shared CAF of ``caf.py``.  None imports the port.  Each
has ``lag_range(cell)`` and ``run(cell, item, probes, precision)``; the
reference of an entry with ``slots`` asks ``caf.peaks`` for its lattice
under a ``caf.Box`` of sizes it reads from its own files, and that of a
cell with a rate grid passes each rate's chirp of the needle."""
