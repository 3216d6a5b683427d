"""The benchmark's general code: the manifest and the module finder, the
generators, the trace reduction, the table of peaks and the comparison
that decides ``correct``. Everything that belongs to one configuration,
traffic mix, index mode, corpus law, driver, entry, unit of work or metric
lives in files of its own (``configs/``, ``traffic/``, ``modes/``,
``corpora/``, ``drivers/``, ``entries/``, ``work/``, ``metrics/``), found
by the name in ``BENCHMARK.json`` or in those files."""
