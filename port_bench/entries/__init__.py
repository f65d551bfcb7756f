"""One driver per entry the window drives, ``traffic/<mix>.json``'s
``entry``: each module's ``Entry`` sets up from the seed, measures
(``window``, ``traced``), reads the program's answers back (``collect``)
and compares them with ``port_bench.reference`` (``check``)."""
