"""Public entries of the port that a window drives, one a file.

Each has ``prepare(cell, item)`` (a pool item's inputs, put where the
search takes them), ``search(cell, prepared, clock)`` (one search: the
whole public call, its answer on the host) and ``pairs(answer)`` (each
pair's final ``(freq Hz, lag, value)``, read once the window has
closed; on a cell with a rate grid ``(rate Hz/s, freq Hz, lag,
value)``).  An entry that answers each chunk it is fed as well has
``chunks(answer)``: each pair's list of chunk peaks, in the order fed,
which its reference's ``chunk_spans(cell)`` pairs with their lags.  An
entry that answers several emitters a pair has ``slots(answer)``: each
pair's answers, strongest first, an empty slot's value -inf, judged
against its reference's lattice (``compare.py``)."""
