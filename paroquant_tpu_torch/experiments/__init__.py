"""Experiments: the port of `experiments/plots/plot_kernel_speedup.py`."""
