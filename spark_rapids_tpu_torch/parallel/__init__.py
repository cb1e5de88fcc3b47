"""Distributed execution over the shards of a mesh (``runner.py``)."""
