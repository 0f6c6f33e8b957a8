"""Logging, profiling and system information."""
