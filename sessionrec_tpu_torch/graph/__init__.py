"""Dense session-graph construction (numpy) and batch containers."""
