"""Decomposition of a domain into blocks (``domain.py``): so far the
single-block part the out-of-core chunks use."""
