"""Configuration and logging."""
