"""The benchmark's general machinery: cells found by name, synthetic
inputs, spans, the device trace, and the comparison that decides
``correct``.  Nothing here belongs to one configuration, traffic mix or
metric."""
