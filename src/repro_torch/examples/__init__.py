"""Runnable examples of the port, twins of the repository's
``examples/serve_lm.py``, ``serve_stream.py``, ``train_lm.py``,
``sync_primitives.py`` and ``quickstart.py``: the same workloads and
asserts, through ``repro_torch`` on ``--device`` (``cuda`` by default;
``--device cpu`` runs the plain versions)."""
