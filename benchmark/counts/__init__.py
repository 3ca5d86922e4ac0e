"""Analytic operation and byte counts: the yardstick of the roofline and
utilisation metrics, computed from shapes and the benchmark's own inputs,
never from the program."""
