"""The W4 kernel benchmarks: ports of `scripts/kernel_bench3.py` and `scripts/kernel_bench4.py`."""
