"""The benchmark of the PyTorch and CUDA port: ``python3 -m benchmark.run``
runs one cell of ``BENCHMARK.json`` (see ``benchmark/run.py``)."""
