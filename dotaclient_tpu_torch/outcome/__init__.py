"""Episode outcomes: the counter schema and the in-graph reductions."""
