"""Baselines: the port of `experiments/baselines/quality_ladder.py`'s outlier injection."""
