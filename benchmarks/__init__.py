"""The benchmark of the PyTorch and CUDA port (``cudacam_tpu_torch``): one
command runs one cell of ``BENCHMARK.json`` once (``run.py``)."""
