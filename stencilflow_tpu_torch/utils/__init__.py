"""Shared utilities: graph plotting (the JAX package's log levels are
``driver.py``'s ``log_level``)."""
from .plot import chain_graph_dot, plot_chain_graph, plot_compute_graph

__all__ = ["chain_graph_dot", "plot_chain_graph", "plot_compute_graph"]
