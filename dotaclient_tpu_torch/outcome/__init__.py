"""Episode outcomes: the counter schema, the in-graph reductions and the
learner's windowed curves."""
