"""Masked reductions, dropout, scoring and the fused catalog loss."""
