"""The benchmark of the PyTorch and CUDA port, ``gnn_tpu_torch``: one cell
run once per call of ``python3 gnnbench/run.py``."""
