"""See ``bench/run.py``: files here are found by name."""
