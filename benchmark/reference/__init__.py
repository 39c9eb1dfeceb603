"""Plain references, one a public entry of the port (``<entry>.py``),
each over the shared CAF of ``caf.py``.  None imports the port."""
