"""Serving: prefill / decode steps, the slot scheduler and the wave server."""
