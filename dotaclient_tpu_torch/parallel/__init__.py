"""Parallel building blocks. One card holds every expert, so only the
routing math of expert parallelism is here (``expert.py``)."""
