"""Straggler mitigation (``straggler``)."""
