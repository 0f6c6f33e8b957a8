"""Streaming host<->device pipeline and tracing."""
